"""Build and load the port's CUDA kernels.

The sources under ``src/repro_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` at first use: one ``nvcc -c`` per source, all started together,
then one link into a single shared library with a plain C interface,
loaded with ``ctypes``.  The library lands in ``build/kernels-<hash>/`` at
the repository root, keyed by a hash of the sources and flags, so an
unchanged tree reuses it and a changed one rebuilds; it is built in a
private directory beside that one and renamed into place.  Nothing here
runs at import time.

``defines`` (``NAME`` or ``NAME=VALUE``, passed to nvcc as ``-D``) build a
variant of the library into a directory of its own: the sources name the
macros they read.  The port always loads the library built with none;
``launch/kernel_variants.py`` and the card tests build the others.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("expert_ffn.cu", "flash_attention.cu", "residual_int8.cu",
           "rwkv6_scan.cu", "paced_copy.cu", "expert_ffn_bwd.cu",
           "flash_attention_bwd.cu", "flash_attention_bwd_masked.cu", "rwkv6_scan_bwd.cu")
HEADERS = ("common.cuh", "tf32_mma.cuh", "expert_ffn_gemm.cuh", "expert_ffn_wgmma.cuh",
           "flash_attention_bwd.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
CFLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libdice_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
SIGNATURES = {
    "dice_expert_ffn": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "dice_flash_attention": [_P] * 7 + [_I] * 7 + [_L] * 12
    + [_I] * 5 + [_F, _I, _I, _P],
    "dice_expert_ffn_bwd": [_P] * 11 + [_I] * 8 + [_P],
    "dice_flash_attention_bwd": [_P] * 10 + [_I] * 6 + [_L] * 15 + [_I] * 5 + [_F]
    + [_I] * 2 + [_P],
    "dice_flash_attention_bwd_masked": [_P] * 10 + [_I] * 6 + [_L] * 15 + [_I] * 5 + [_F]
    + [_I] * 2 + [_P],
    "dice_residual_int8": [_P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _P],
    "dice_rwkv6_scan": [_P] * 8 + [_I] * 4 + [_L] * 12 + [_I] * 4 + [_P],
    "dice_rwkv6_scan_bwd": [_P] * 15 + [_I] * 4 + [_L] * 15 + [_I] * 4 + [_P],
    "dice_paced_copy": [_P, _P, _L, _L, _I, _P],
}

# seconds the last build took in this process (0.0 when the library was
# already built); chip_smoke.py reports it
build_stats: Dict[str, float] = {"seconds": 0.0}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _flags(defines: Tuple[str, ...]) -> Tuple[str, ...]:
    return CFLAGS + tuple(f"-D{d}" for d in defines)


def source_hash(defines: Tuple[str, ...] = ()) -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(ARCH + _flags(defines)).encode())
    return h.hexdigest()[:16]


def build_dir(defines: Tuple[str, ...] = ()) -> Path:
    return BUILD_ROOT / f"kernels-{source_hash(defines)}"


def build(defines: Tuple[str, ...] = ()) -> Path:
    """Compile every source in parallel and link them; returns the library
    path.  Compiler output (ptxas register/spill lines) goes to
    ``build.log`` beside the library.

    Objects, log and library are made in a directory of this process's own
    and published by renaming the whole directory, so two processes that
    build at once never read each other's half-written files."""
    out = build_dir(defines)
    lib = out / LIB_NAME
    if lib.exists():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix=f"{out.name}.", dir=BUILD_ROOT))
    try:
        seconds = _compile_and_link(work, defines)
        try:
            os.rename(work, out)       # atomic: a loader sees all or none
        except OSError:
            if not lib.exists():       # a stale partial directory, not a winner
                shutil.rmtree(out, ignore_errors=True)
                os.rename(work, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    build_stats["seconds"] = seconds
    return lib


def _compile_and_link(work: Path, defines: Tuple[str, ...]) -> float:
    """Build ``LIB_NAME`` and ``build.log`` into ``work``; returns seconds."""
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = []
    for name in SOURCES:
        obj = work / (Path(name).stem + ".o")
        cmd = [nvcc, *ARCH, *_flags(defines), "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for name, _, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== {name} (rc {proc.returncode})\n{text}")
        if proc.returncode != 0:
            failed.append(name)
    (work / "build.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(work / LIB_NAME),
         *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (once a process)."""
    lib = ctypes.CDLL(str(build(defines)))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


_KERNEL = re.compile(r"(gate_up|down|bwd_wgmma|flash_bwd_dkdv|flash_bwd_dq|flash"
                     r"|residual_int8_loop|residual_int8|rwkv6_scan_bwd_finish"
                     r"|rwkv6_scan_bwd|rwkv6_scan|widen)_kernel"
                     r"(?:I(f|13__nv_bfloat16)?(?:Li(\d+)E)?(f|13__nv_bfloat16)?(Lb1E)?)?")
_DTYPES = {"f": "f32", "13__nv_bfloat16": "bf16"}   # mangled template arguments


def _kernel_label(mangled: str) -> str:
    """``name<dtype, int, dtype, masks>`` of a kernel's mangled symbol,
    with the template arguments it has (``bwd_wgmma<2, bf16>``; a trailing
    ``true``: ``flash_bwd_dq<bf16, 32, masks>``)."""
    m = _KERNEL.search(mangled)
    if m is None:
        return ""
    args = ", ".join(a for a in (_DTYPES.get(m[2]), m[3], _DTYPES.get(m[4]),
                                 "masks" if m[5] else None) if a)
    return f"{m[1]}<{args}>" if args else m[1]


def sass_opcodes(opcodes: Tuple[str, ...],
                 defines: Tuple[str, ...] = ()) -> Dict[str, Dict[str, int]]:
    """How often each of ``opcodes`` (``HGMMA`` for wgmma, ``HMMA`` for
    mma.sync, ``FFMA``) occurs in each kernel of a built library's SASS,
    by ``cuobjdump -sass`` from the toolkit beside nvcc."""
    cuobjdump = Path(nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(build(defines))],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, check=True).stdout
    pattern = re.compile(r"\b(" + "|".join(opcodes) + r")\b")
    counts: Dict[str, Dict[str, int]] = {}
    current = None
    for line in text.splitlines():
        if "Function :" in line:
            label = _kernel_label(line)
            current = counts.setdefault(label, dict.fromkeys(opcodes, 0)) \
                if label else None
        elif current is not None:
            m = pattern.search(line)
            if m:
                current[m[1]] += 1
    return counts


def ptxas_report(defines: Tuple[str, ...] = ()) -> List[str]:
    """ptxas's register and spill lines from ``build.log`` of a built
    library, each led by its kernel (``gate_up<f32>: ...``), and the log's
    ``== source`` headers."""
    lines, kernel = [], ""
    for line in (build_dir(defines) / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            label = _kernel_label(line)
            kernel = f"{label}: " if label else ""
        if "registers" in line or "spill" in line:
            lines.append(f"{kernel}{line.strip()}")
        elif line.startswith("=="):
            lines.append(line.strip())
    return lines
