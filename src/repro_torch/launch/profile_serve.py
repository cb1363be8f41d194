"""Where a serving step's device time goes, by kernel.

Serves one batch on the card under ``torch.profiler`` and prints the CUDA
kernels ranked by device time, grouped into the port's hand-written
kernels, cuBLAS products and everything else, with the device's busy
share of the wall time (one stream, so kernel time over wall time)::

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --schedule dice --codec int8_residual --steps 4

Defaults to DiT-MoE-XL at 8 requests from random weights (the weights do
not change any shape, so they do not change the time).  A warm-up call
runs first and is not traced.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.compress.codecs import CODEC_KINDS, CompressConfig
from repro_torch.configs.dit_moe_xl import config as xl_config, tiny
from repro_torch.launch.serve import SCHEDULES, DiceServer, Request

# substrings of the port's kernel symbols (csrc/*.cu) -> wrapper name
OWN_KERNELS = {"gate_up_kernel": "expert_ffn", "down_kernel": "expert_ffn",
               "flash_kernel": "flash_attention",
               "residual_int8_kernel": "residual_int8"}


def kernel_group(name: str) -> str:
    for key, group in OWN_KERNELS.items():
        if key in name:
            return group
    low = name.lower()
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "cublas_gemm"
    return "other"


def device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--schedule", choices=list(SCHEDULES), default="dice")
    ap.add_argument("--codec", choices=list(CODEC_KINDS), default="int8_residual")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tiny() if args.tiny else xl_config()
    server = DiceServer(cfg, SCHEDULES[args.schedule](), device="cuda",
                        compress=CompressConfig(args.codec))
    reqs = [Request(class_id=i % cfg.num_classes, rid=i)
            for i in range(args.requests)]
    server.generate(reqs, num_steps=1)                 # warm-up, not traced
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _, stats = server.generate(reqs, num_steps=args.steps)
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(device_us(e) for e in kernels)
    groups = {}
    for e in kernels:
        g = groups.setdefault(kernel_group(e.key), [0.0, 0])
        g[0] += device_us(e)
        g[1] += e.count
    print(f"{cfg.name}, {args.requests} requests, {args.schedule}, codec "
          f"{args.codec}, {args.steps} steps on {torch.cuda.get_device_name(0)}")
    print(f"wall {wall_us / 1e3:.3f} ms ({wall_us / 1e3 / args.steps:.3f} ms/step, "
          f"generate's own {stats['wall_s_per_step'] * 1e3:.3f} ms/step); "
          f"kernel time {total / 1e3:.3f} ms; device busy "
          f"{100.0 * total / wall_us:.1f}%")
    print(f"{'group':16s} {'ms/step':>10s} {'share':>7s} {'launches/step':>14s}")
    for g, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"{g:16s} {us / 1e3 / args.steps:10.3f} {100.0 * us / total:6.1f}% "
              f"{n / args.steps:14.1f}")
    print(f"top {args.top} kernels by device time:")
    for e in sorted(kernels, key=device_us, reverse=True)[:args.top]:
        print(f"  {device_us(e) / 1e3 / args.steps:9.3f} ms/step "
              f"{e.count / args.steps:7.1f}x  {e.key[:110]}")
    print(json.dumps({"wall_ms_per_step": wall_us / 1e3 / args.steps,
                      "busy_share": total / wall_us,
                      "groups_ms_per_step": {g: v[0] / 1e3 / args.steps
                                             for g, v in groups.items()}}))


if __name__ == "__main__":
    main()
