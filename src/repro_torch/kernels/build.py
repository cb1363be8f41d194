"""Build and load the port's CUDA kernels.

The sources under ``src/repro_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` at first use: one ``nvcc -c`` per source, all started together,
then one link into a single shared library with a plain C interface,
loaded with ``ctypes``.  The library lands in ``build/kernels-<hash>/`` at
the repository root, keyed by a hash of the sources and flags, so an
unchanged tree reuses it and a changed one rebuilds; it is built in a
private directory beside that one and renamed into place.  Nothing here
runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("expert_ffn.cu", "flash_attention.cu", "residual_int8.cu")
HEADERS = ("common.cuh",)
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
CFLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libdice_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
SIGNATURES = {
    "dice_expert_ffn": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "dice_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I]
    + [_L] * 12 + [_I, _I, _I, _I, _F, _I, _I, _P],
    "dice_residual_int8": [_P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _P],
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


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(ARCH + CFLAGS).encode())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / f"kernels-{source_hash()}"


def build() -> Path:
    """Compile every source in parallel and link them; returns the library
    path.  Compiler output (ptxas register/spill lines) goes to
    ``build.log`` beside the library.

    Objects, log and library are made in a directory of this process's own
    and published by renaming the whole directory, so two processes that
    build at once never read each other's half-written files."""
    out = build_dir()
    lib = out / LIB_NAME
    if lib.exists():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix=f"{out.name}.", dir=BUILD_ROOT))
    try:
        seconds = _compile_and_link(work)
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


def _compile_and_link(work: Path) -> float:
    """Build ``LIB_NAME`` and ``build.log`` into ``work``; returns seconds."""
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = []
    for name in SOURCES:
        obj = work / (Path(name).stem + ".o")
        cmd = [nvcc, *ARCH, *CFLAGS, "-c", str(CSRC / name), "-o", str(obj)]
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
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (once a process)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
