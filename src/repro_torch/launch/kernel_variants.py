"""Time the design alternatives of the tensor-core kernels, on the card.

A variant is the kernel library built with ``-D`` macros that the sources
read (``csrc/expert_ffn.cu``, ``csrc/flash_attention.cu``,
``csrc/tf32_mma.cuh`` name them): another tiling, or a diagnostic that runs
one TF32 pass instead of the 3xTF32 split (fast, not f32-accurate).  Every
library is built by :mod:`repro_torch.kernels.build`, all at once; then the
wrappers of :mod:`repro_torch.kernels.ops` launch each in turn at the
DiT-MoE-XL shapes, held against the plain version and timed with CUDA
events, in two rounds in one process::

    PYTHONPATH=src python -m repro_torch.launch.kernel_variants

Prints the card, ptxas's registers and spills of each variant's f32 kernels,
then one line per round, shape and variant: ms, max abs error and whether
it meets the f32 tolerance.  Needs nvcc and a CUDA device.
"""
from __future__ import annotations

import math
import subprocess
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import torch

from repro_torch.kernels import build, ops, ref
from repro_torch.launch.timing import time_ms

TOL_F32 = dict(rtol=1e-4, atol=1e-4)
# name -> (the wrapper whose kernel it changes, or None for both; -D macros)
VARIANTS = {
    "committed": (None, ()),
    "64-row blocks, 4 warps of 64 x 32": ("expert_ffn", ("DICE_FFN_WARPS_M=1",)),
    "3 stages": ("expert_ffn", ("DICE_FFN_STAGES=3",)),
    "4 warps x 64 rows, 64-key tiles": (
        "flash_attention", ("DICE_FLASH_WARPS=4", "DICE_FLASH_KEYS=64")),
    "one TF32 pass (diagnostic, not f32-accurate)": (None, ("DICE_TF32_ONE_PASS",)),
}


def cases(gen):
    """(label, wrapper name, call, plain result, timing iterations)."""
    kw = dict(generator=gen, device="cuda")
    E, d, f = 8, 1152, 4608
    wg = torch.randn((E, d, f), **kw) / math.sqrt(d)
    wu = torch.randn((E, d, f), **kw) / math.sqrt(d)
    wd = torch.randn((E, f, d), **kw) / math.sqrt(f)
    for C, label in ((640, "refresh"), (320, "light")):
        buf = torch.randn((E, C, d), **kw)
        yield (f"expert_ffn XL {label} E={E} C={C} d={d} f={f} f32", "expert_ffn",
               lambda buf=buf: ops.expert_ffn(buf, wg, wu, wd),
               ref.expert_ffn_ref(buf, wg, wu, wd), 10)
    q, k, v = (torch.randn((8, 256, 16, 72), **kw) for _ in range(3))
    yield ("flash_attention XL (8, 256, 16, 72) f32", "flash_attention",
           lambda: ops.flash_attention(q, k, v), ref.flash_attention_ref(q, k, v), 50)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip() or torch.cuda.get_device_name(0))
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build.library,
                                           (d for _, d in VARIANTS.values()))))
    for name, (_, defines) in VARIANTS.items():
        for line in build.ptxas_report(defines):
            if line.startswith(("gate_up<f32", "down<f32", "flash<f32")):
                print(f"[{name}] {line}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, wrapper, call, want, iters in cases(gen):
        names = [n for n, (w, _) in VARIANTS.items() if w in (None, wrapper)]
        for rnd in (1, 2):
            for name in names:
                with mock.patch.object(ops, "library", lambda lib=libs[name]: lib):
                    out = call()
                    err = (out - want).abs()
                    ok = not bool((err > TOL_F32["atol"]
                                   + TOL_F32["rtol"] * want.abs()).any())
                    ms = time_ms(call, iters)
                print(f"round {rnd} {label} [{name}]: {ms:.4f} ms, max abs err "
                      f"{float(err.max()):.3e}, meets rtol=atol=1e-4: {ok}")


if __name__ == "__main__":
    main()
