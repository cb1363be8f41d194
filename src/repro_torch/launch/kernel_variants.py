"""Time the design alternatives of the port's kernels, on the card.

A variant is the kernel library built with ``-D`` macros that the sources
read (``csrc/expert_ffn.cu``, ``csrc/flash_attention.cu``,
``csrc/tf32_mma.cuh``, ``csrc/rwkv6_scan.cu``, ``csrc/residual_int8.cu``,
``csrc/expert_ffn_bwd.cu``, ``csrc/flash_attention_bwd.cu`` and
``csrc/rwkv6_scan_bwd.cu`` name them): another tiling or tile size, the
int8 codec's looping path for every row, or a diagnostic that shows what a
part costs by leaving it out: one TF32 pass instead of the 3xTF32 split
(fast, not f32-accurate), the scan without its row-group reduction or
without widening its staged tiles, the scan's backward with one kind of
block alone, without its sums inside a chunk (wrong outputs) or with less
shared memory free.  Every library is built by
:mod:`repro_torch.kernels.build`, all at once; then the wrappers of
:mod:`repro_torch.kernels.ops` launch each in turn at the main paths'
shapes, held against the plain version and timed, in two rounds in one
process::

    PYTHONPATH=src python -m repro_torch.launch.kernel_variants \\
        [--kernels rwkv6_scan,residual_int8]

The tensor-core kernels (the two forward and the two DiT backward ones)
are timed with CUDA events (``time_ms``), the two short ones and the
scan's backward by their device time alone (``device_ms``; the int8
codec's inputs rotate over three sets, 113 MB, and the scan backward's at
the training shape over three, 78 MB, so each call reads from HBM).
Prints the card, ptxas's registers and spills of each variant's kernels at
those shapes, then one line per round, shape and variant: ms, max abs error
and whether it meets the kernel's tolerance.  Needs nvcc and a CUDA device.
"""
from __future__ import annotations

import argparse
import math
import subprocess
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import torch

from repro_torch.kernels import build, ops, ref
from repro_torch.launch.timing import device_ms, rotating, time_ms

TOL_F32 = dict(rtol=1e-4, atol=1e-4)
TOL_SCAN = dict(rtol=1e-3, atol=1e-3)
KERNELS = ("expert_ffn", "flash_attention", "rwkv6_scan", "residual_int8",
           "expert_ffn_bwd", "flash_attention_bwd", "rwkv6_scan_bwd")
# name -> (the wrappers whose kernels it changes; -D macros)
VARIANTS = {
    "committed": (KERNELS, ()),
    "64-row blocks, 4 warps of 64 x 32": (("expert_ffn",), ("DICE_FFN_WARPS_M=1",)),
    "3 stages": (("expert_ffn",), ("DICE_FFN_STAGES=3",)),
    "4 warps x 64 rows, 64-key tiles": (
        ("flash_attention",), ("DICE_FLASH_WARPS=4", "DICE_FLASH_KEYS=64")),
    "one TF32 pass (diagnostic, not f32-accurate)": (
        ("expert_ffn", "flash_attention", "expert_ffn_bwd", "flash_attention_bwd",
         "rwkv6_scan_bwd"), ("DICE_TF32_ONE_PASS",)),
    "backward pass 0 at 128 columns": (("expert_ffn_bwd",), ("DICE_BWD_GU_BN=128",)),
    "backward kernels with the cvt.rna split": (
        ("expert_ffn_bwd", "flash_attention_bwd"), ("DICE_BWD_CVT_SPLIT",)),
    "flash backward: 64-row streamed tiles": (
        ("flash_attention_bwd",), ("DICE_FLASH_BWD_TILE=64",)),
    "flash backward: 16-row streamed tiles": (
        ("flash_attention_bwd",), ("DICE_FLASH_BWD_TILE=16",)),
    "flash backward: 8 warps, 128 owned rows": (
        ("flash_attention_bwd",), ("DICE_FLASH_BWD_WARPS=8",)),
    "4 row groups x 4 columns (16 x 4 patch, 2 warps)": (
        ("rwkv6_scan",), ("DICE_SCAN_ROW_GROUPS=4",)),
    "8 row groups x 8 columns (8 x 8 patch, 2 warps)": (
        ("rwkv6_scan",), ("DICE_SCAN_COLS=8",)),
    "scan tiles of 32 steps": (("rwkv6_scan",), ("DICE_SCAN_TILE=2048",)),
    "scan readouts reduced 16 steps at a time": (("rwkv6_scan",), ("DICE_SCAN_GROUP=16",)),
    "scan without the row-group reduction (diagnostic, wrong outputs)": (
        ("rwkv6_scan",), ("DICE_SCAN_NO_REDUCE",)),
    "scan without the widening pass (diagnostic, wrong outputs)": (
        ("rwkv6_scan",), ("DICE_SCAN_NO_WIDEN",)),
    "int8 looping path for every row": (("residual_int8",), ("DICE_INT8_LOOP",)),
    "scan backward: the G side's blocks alone (diagnostic, wrong outputs)": (
        ("rwkv6_scan_bwd",), ("DICE_SCAN_BWD_ONLY=0",)),
    "scan backward: the P side's blocks alone (diagnostic, wrong outputs)": (
        ("rwkv6_scan_bwd",), ("DICE_SCAN_BWD_ONLY=1",)),
    "scan backward without the sums inside a chunk (diagnostic, wrong outputs)": (
        ("rwkv6_scan_bwd",), ("DICE_SCAN_BWD_NO_INTRA",)),
    "scan backward at 2 blocks an SM (diagnostic: 20 KB more shared memory asked)": (
        ("rwkv6_scan_bwd",), ("DICE_SCAN_BWD_SMEM_EXTRA=20480",)),
}
PTXAS_KERNELS = ("gate_up<f32", "down<f32", "flash<f32", "rwkv6_scan<64>",
                 "residual_int8<f32, 9>", "residual_int8_loop<f32>", "bwd_wgmma",
                 "flash_bwd_dq<9>", "flash_bwd_dkdv<9>", "rwkv6_scan_bwd<bf16, 64>",
                 "rwkv6_scan_bwd_finish")


def _max_err(got, want, tol):
    err = (got.float() - want.float()).abs()
    return (float(err.max()),
            not bool((err > tol["atol"] + tol["rtol"] * want.float().abs()).any()))


def _check_tensor(want, tol):
    return lambda out: _max_err(out, want, tol)


def _check_scan(want):
    def check(out):
        (e1, ok1), (e2, ok2) = (_max_err(o, w, TOL_SCAN) for o, w in zip(out, want))
        return max(e1, e2), ok1 and ok2
    return check


def _check_grads(want, sums):
    """Each gradient to TOL_F32, with the atol of a tensor-core sum of
    ``sums[i]`` products (chip_smoke.py's ``compare_sum``) where given."""
    def check(out):
        errs, oks = [], []
        for o, w, n in zip(out, want, sums):
            tol = dict(TOL_F32)
            if n:
                tol["atol"] += max(TOL_F32["rtol"], n * 2.0 ** -24) * float(w.abs().max())
            err, ok = _max_err(o, w, tol)
            errs.append(err)
            oks.append(ok)
        return max(errs), all(oks)
    return check


def _check_scan_bwd(want, n):
    """(dr, dk, dv, dlogw, du, ds0) as chip_smoke.py's ``compare_scan_bwd``
    holds them: TOL_F32 (bf16 outputs 2e-2) plus an atol of ``n`` terms'
    tensor-core drift of each tensor's largest value."""
    def check(out):
        errs, oks = [], []
        for o, w in zip(out, want):
            tol = dict(TOL_F32) if w.dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
            tol["atol"] += max(TOL_F32["rtol"], n * 2.0 ** -24) * float(w.float().abs().max())
            err, ok = _max_err(o, w, tol)
            errs.append(err)
            oks.append(ok)
        return max(errs), all(oks)
    return check


def _check_int8(want):
    def check(out):
        err, ok = _max_err(out[2], want[2], dict(rtol=1e-6, atol=1e-6))
        return err, ok and torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
    return check


def cases(gen, kernels):
    """(label, wrapper name, call, check(out) -> (max abs err, ok), timed()
    -> ms)."""
    kw = dict(generator=gen, device="cuda")
    if "expert_ffn" in kernels:
        E, d, f = 8, 1152, 4608
        wg = torch.randn((E, d, f), **kw) / math.sqrt(d)
        wu = torch.randn((E, d, f), **kw) / math.sqrt(d)
        wd = torch.randn((E, f, d), **kw) / math.sqrt(f)
        for C, label in ((640, "refresh"), (320, "light")):
            buf = torch.randn((E, C, d), **kw)
            call = lambda buf=buf: ops.expert_ffn(buf, wg, wu, wd)   # noqa: E731
            yield (f"expert_ffn XL {label} E={E} C={C} d={d} f={f} f32", "expert_ffn",
                   call, _check_tensor(ref.expert_ffn_ref(buf, wg, wu, wd), TOL_F32),
                   lambda call=call: time_ms(call, 10))
    if "flash_attention" in kernels:
        q, k, v = (torch.randn((8, 256, 16, 72), **kw) for _ in range(3))
        call = lambda: ops.flash_attention(q, k, v)                  # noqa: E731
        yield ("flash_attention XL (8, 256, 16, 72) f32", "flash_attention", call,
               _check_tensor(ref.flash_attention_ref(q, k, v), TOL_F32),
               lambda call=call: time_ms(call, 50))
    if "expert_ffn_bwd" in kernels:
        E, C, d, f = 8, 640, 1152, 4608
        x = torch.randn((E, C, d), **kw)
        wg, wu = (torch.randn((E, d, f), **kw) / math.sqrt(d) for _ in range(2))
        wd = torch.randn((E, f, d), **kw) / math.sqrt(f)
        dy = torch.randn((E, C, d), **kw)
        call = lambda: ops.expert_ffn_bwd(x, wg, wu, wd, dy)          # noqa: E731
        yield (f"expert_ffn_bwd XL refresh E={E} C={C} d={d} f={f} f32", "expert_ffn_bwd",
               call, _check_grads(ref.expert_ffn_bwd_ref(x, wg, wu, wd, dy),
                                  (2 * f + d, C + d, C + d, C + d)),
               lambda call=call: time_ms(call, 10))
    if "flash_attention_bwd" in kernels:
        q, k, v, do = (torch.randn((8, 256, 16, 72), **kw) for _ in range(4))
        o, lse, _ = ops._flash_attention_fwd(q, k, v, want_lse=True)
        call = lambda: ops.flash_attention_bwd(q, k, v, o, lse, do)   # noqa: E731
        yield ("flash_attention_bwd XL (8, 256, 16, 72) f32", "flash_attention_bwd", call,
               _check_grads(ref.flash_attention_bwd_ref(q, k, v, o, lse, do), (0, 0, 0)),
               lambda call=call: time_ms(call, 50))
    if "rwkv6_scan" in kernels:
        # decode rotates over 8 states (84 MB), as 32 layers' states would
        for T, n_sets, iters in ((2048, 1, 20), (1, 8, 200)):
            sets = [scan_inputs(gen, 8, 40, T, 64) for _ in range(n_sets)]
            label = "prefill" if T > 1 else "decode"
            yield (f"rwkv6_scan {label} (8, 40, {T}, 64) bf16", "rwkv6_scan",
                   lambda args=sets[0]: ops.rwkv6_scan(*args),
                   _check_scan(ref.rwkv6_scan_ref(*sets[0])),
                   lambda sets=sets, iters=iters: device_ms(
                       rotating(ops.rwkv6_scan, sets), iters))
    if "rwkv6_scan_bwd" in kernels:
        # the training shape rotates over 3 input sets (78 MB), as chip_smoke.py 13a
        for T, n_sets, iters in ((128, 3, 30), (2048, 1, 5)):
            sets = [(*scan_inputs(gen, 8, 40, T, 64),
                     torch.randn((8, T, 40, 64), **kw).permute(0, 2, 1, 3))
                    for _ in range(n_sets)]
            yield (f"rwkv6_scan_bwd (8, 40, {T}, 64) bf16, dS_T none", "rwkv6_scan_bwd",
                   lambda args=sets[0]: ops.rwkv6_scan_bwd(*args),
                   _check_scan_bwd(ref.rwkv6_scan_bwd_ref(*sets[0]), T + 64),
                   lambda sets=sets, iters=iters: device_ms(
                       rotating(ops.rwkv6_scan_bwd, sets), iters))
    if "residual_int8" in kernels:
        for N in (4096, 8192):
            sets = [int8_inputs(gen, N, 1152) for _ in range(3)]
            yield (f"residual_int8 N={N} d=1152 f32, 3 input sets", "residual_int8",
                   lambda args=sets[0]: ops.residual_int8(*args),
                   _check_int8(ref.residual_int8_ref(*sets[0])),
                   lambda sets=sets: device_ms(rotating(ops.residual_int8, sets), 300))


def scan_inputs(gen, B, H, T, DK, dtype=torch.bfloat16):
    """r/k/v in ``dtype`` as (B, T, H, DK) projections permuted to (B, H, T,
    DK) as the model passes them, logw f32 likewise, u in ``dtype``, a
    random f32 state."""
    kw = dict(generator=gen, device="cuda")
    r, k, v = (torch.randn((B, T, H, DK), **kw).to(dtype).permute(0, 2, 1, 3)
               for _ in range(3))
    logw = (-torch.exp(torch.randn((B, T, H, DK), **kw) - 3.0)).permute(0, 2, 1, 3)
    u = (0.5 + 0.1 * torch.randn((H, DK), **kw)).to(dtype)
    s0 = 0.1 * torch.randn((B, H, DK, DK), **kw)
    return r, k, v, logw, u, s0


def int8_inputs(gen, N, d, dtype=torch.float32):
    """A payload and its residual base, 0.1 apart."""
    value = torch.randn((N, d), generator=gen, device="cuda")
    base = value + 0.1 * torch.randn((N, d), generator=gen, device="cuda")
    return value.to(dtype), base.to(dtype)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated wrappers to time (default: all)")
    kernels = tuple(ap.parse_args(argv).kernels.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip() or torch.cuda.get_device_name(0))
    variants = {n: v for n, v in VARIANTS.items() if set(v[0]) & set(kernels)}
    with ThreadPoolExecutor(len(variants)) as pool:
        libs = dict(zip(variants, pool.map(build.library,
                                           (d for _, d in variants.values()))))
    for name, (_, defines) in variants.items():
        for line in build.ptxas_report(defines):
            if line.startswith(PTXAS_KERNELS):
                print(f"[{name}] {line}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, wrapper, call, check, timed in cases(gen, kernels):
        names = [n for n, (w, _) in variants.items() if wrapper in w]
        for rnd in (1, 2):
            for name in names:
                with mock.patch.object(ops, "library", lambda lib=libs[name]: lib):
                    err, ok = check(call())
                    ms = timed()
                print(f"round {rnd} {label} [{name}]: {ms:.4f} ms, max abs err "
                      f"{err:.3e}, meets its tolerance: {ok}")


if __name__ == "__main__":
    main()
