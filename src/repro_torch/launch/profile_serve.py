"""Where a serving step's device time goes, by kernel.

Serves one batch on the card under ``torch.profiler`` and prints the CUDA
kernels ranked by device time, grouped into the port's hand-written
kernels, cuBLAS products and everything else, with the device's busy
share of the wall time (one stream, so kernel time over wall time)::

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --schedule dice --codec int8_residual --steps 4

Defaults to DiT-MoE-XL at 8 requests from random weights (the weights do
not change any shape, so they do not change the time).  A warm-up call
runs first and is not traced.  ``--obs`` serves with the staleness
telemetry on, which names each MoE layer's action as a profiler range
(``moe_lNN_<mode>``); the ranges are listed after the kernels.  Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.compress.codecs import CODEC_KINDS, CompressConfig
from repro_torch.configs.dit_moe_xl import config as xl_config, tiny
from repro_torch.launch.serve import SCHEDULES, DiceServer, Request
from repro_torch.launch.timing import device_us
from repro_torch.obs import ObsConfig

# substrings of the port's kernel symbols (csrc/*.cu) -> wrapper name
OWN_KERNELS = {"gate_up_kernel": "expert_ffn", "down_kernel": "expert_ffn",
               "flash_kernel": "flash_attention",
               "bwd_wgmma_kernel": "expert_ffn_bwd", "widen_kernel": "expert_ffn_bwd",
               "flash_bwd_": "flash_attention_bwd",
               "residual_int8_kernel": "residual_int8",
               "residual_int8_loop_kernel": "residual_int8",
               "rwkv6_scan_kernel": "rwkv6_scan",
               "rwkv6_scan_bwd_kernel": "rwkv6_scan_bwd",
               "rwkv6_scan_bwd_finish_kernel": "rwkv6_scan_bwd"}


# named ranges, which a trace also lists on the device as the span of the
# kernels launched inside them: --obs's per-layer ranges, rf_train_step's
# and lm_train_step's parts and the recomputed layers (layers.remat;
# launch/profile_train.py)
RANGES = ("moe_l", "rf_train_step.", "lm_train_step.", "layers.remat")


def kernel_group(name: str) -> str:
    for key, group in OWN_KERNELS.items():
        if key in name:
            return group
    low = name.lower()
    if any(key in low for key in ("gemm", "cutlass", "xmma", "nvjet")):
        return "cublas_gemm"
    return "other"


def kernel_groups(prof):
    """CUDA kernels of a finished ``torch.profiler`` run: (kernel events,
    total device us, {group: [device us, launches]})."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith(RANGES)]
    groups = {}
    for e in kernels:
        g = groups.setdefault(kernel_group(e.key), [0.0, 0])
        g[0] += device_us(e)
        g[1] += e.count
    return kernels, sum(device_us(e) for e in kernels), groups


def print_groups(kernels, total_us, groups, per: int, unit: str, top: int) -> None:
    """The group table and the top kernels, each time divided by ``per``."""
    print(f"{'group':16s} {'ms/' + unit:>10s} {'share':>7s} {'launches/' + unit:>14s}")
    for g, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"{g:16s} {us / 1e3 / per:10.3f} {100.0 * us / total_us:6.1f}% "
              f"{n / per:14.1f}")
    print(f"top {top} kernels by device time:")
    for e in sorted(kernels, key=device_us, reverse=True)[:top]:
        print(f"  {device_us(e) / 1e3 / per:9.3f} ms/{unit} "
              f"{e.count / per:7.1f}x  {e.key[:110]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--schedule", choices=list(SCHEDULES), default="dice")
    ap.add_argument("--codec", choices=list(CODEC_KINDS), default="int8_residual")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--obs", action="store_true",
                    help="telemetry on: per-layer profiler ranges")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tiny() if args.tiny else xl_config()
    server = DiceServer(cfg, SCHEDULES[args.schedule](), device="cuda",
                        compress=CompressConfig(args.codec),
                        obs=ObsConfig(enabled=args.obs))
    reqs = [Request(class_id=i % cfg.num_classes, rid=i)
            for i in range(args.requests)]
    server.generate(reqs, num_steps=1)                 # warm-up, not traced
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _, stats = server.generate(reqs, num_steps=args.steps)
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, total, groups = kernel_groups(prof)
    print(f"{cfg.name}, {args.requests} requests, {args.schedule}, codec "
          f"{args.codec}, {args.steps} steps on {torch.cuda.get_device_name(0)}")
    print(f"wall {wall_us / 1e3:.3f} ms ({wall_us / 1e3 / args.steps:.3f} ms/step, "
          f"generate's own {stats['wall_s_per_step'] * 1e3:.3f} ms/step); "
          f"kernel time {total / 1e3:.3f} ms; device busy "
          f"{100.0 * total / wall_us:.1f}%")
    print_groups(kernels, total, groups, args.steps, "step", args.top)
    if args.obs:
        print("MoE layer ranges (host time):")
        for e in sorted(prof.key_averages(), key=lambda e: e.key):
            if e.key.startswith("moe_l"):
                print(f"  {e.key:24s} {e.count:4d}x {e.cpu_time_total / 1e3:9.3f} ms")
    print(json.dumps({"wall_ms_per_step": wall_us / 1e3 / args.steps,
                      "busy_share": total / wall_us,
                      "groups_ms_per_step": {g: v[0] / 1e3 / args.steps
                                             for g, v in groups.items()}}))


if __name__ == "__main__":
    main()
