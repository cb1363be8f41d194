"""DICE serving engine on one device (port of the fixed-batch half of
``repro.launch.serve``).

Serves class-conditional DiT-MoE generation requests under a selectable
parallelism schedule.  Besides the samples it reports the quantities behind
the paper's claims — per-step dispatch payload, persistent staleness-buffer
bytes — and the measured wall time on the device, plus how often each
hand-written kernel was launched.

  PYTHONPATH=src python -m repro_torch.launch.serve --schedule dice \\
      --requests 8 --steps 10 --no-tiny --codec int8_residual
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from dataclasses import dataclass
from typing import List, Optional

import torch

from repro_torch.common.device import resolve_device
from repro_torch.compress.codecs import CODEC_KINDS, CompressConfig
from repro_torch.configs.dit_moe_xl import config as xl_config, tiny
from repro_torch.core import plan as plan_lib
from repro_torch.core.schedules import DiceConfig
from repro_torch.kernels import ops
from repro_torch.models.dit_moe import init_dit
from repro_torch.sampling.rectified_flow import rf_sample


@dataclass
class Request:
    class_id: int
    rid: int


SCHEDULES = {
    "sync": DiceConfig.sync_ep,
    "displaced": DiceConfig.displaced,
    "interweaved": DiceConfig.interweaved,
    "dice": DiceConfig.dice,
    "staggered_batch": DiceConfig.staggered_batch,
}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class DiceServer:
    """One device serving fixed batches.  ``params`` defaults to a random
    init from ``seed`` drawn on the device; ``compress`` threads a wire
    codec into the schedule config."""

    def __init__(self, cfg, dcfg: DiceConfig, *, params=None, seed: int = 0,
                 device: Optional[str] = None,
                 compress: Optional[CompressConfig] = None):
        if compress is not None:
            dcfg = dataclasses.replace(
                dcfg, compress=None if compress.codec == "none" else compress)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.dcfg = plan_lib.normalize_overlap(dcfg, 1)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_dit(cfg, generator=gen)
        self.params = params

    def plan(self, num_steps: int) -> plan_lib.SchedulePlan:
        """The schedule plan a ``generate`` call will run."""
        return plan_lib.compile_step_plans(
            self.dcfg, self.cfg.num_layers, num_steps,
            experts_per_token=self.cfg.experts_per_token)

    def generate(self, requests: List[Request], *, num_steps: int = 20,
                 guidance: float = 1.5, noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
        """Sample one batch.  Noise comes from ``noise`` or ``generator``
        (default: a generator on the server's device seeded with 0)."""
        classes = torch.tensor([r.class_id for r in requests],
                               dtype=torch.int64, device=self.device)
        if noise is None and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        before = dict(ops.LAUNCHES)
        _sync(self.device)
        t0 = time.perf_counter()
        samples, stats = rf_sample(self.params, self.cfg, self.dcfg,
                                   num_steps=num_steps, classes=classes,
                                   noise=noise, generator=generator,
                                   guidance=guidance)
        _sync(self.device)
        wall = time.perf_counter() - t0
        result = {
            "device": (torch.cuda.get_device_name(self.device)
                       if self.device.type == "cuda" else "cpu"),
            "wall_s": wall,
            "wall_s_per_step": wall / max(num_steps, 1),
            "buffer_bytes": stats["buffer_bytes"][-1]
            if stats["buffer_bytes"] else 0,
            "dispatch_bytes_per_step": stats["dispatch_bytes"],
            "wire_bytes_total": float(sum(stats["dispatch_bytes"])),
            "raw_bytes_total": float(sum(stats["raw_bytes"])),
            "num_plan_variants": stats["num_plan_variants"],
            "kernel_launches": {k: ops.LAUNCHES[k] - before[k]
                                for k in ops.LAUNCHES},
        }
        return samples, result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--schedule", choices=list(SCHEDULES), default="dice")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--tiny", action="store_true", default=True,
                    help="small model (default); --no-tiny for XL shapes")
    ap.add_argument("--no-tiny", dest="tiny", action="store_false")
    ap.add_argument("--codec", choices=list(CODEC_KINDS), default="none",
                    help="wire codec for light/stale steps; refresh steps "
                         "stay lossless")
    ap.add_argument("--guidance", type=float, default=1.5)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = tiny() if args.tiny else xl_config()
    server = DiceServer(cfg, SCHEDULES[args.schedule](), seed=args.seed,
                        device=args.device,
                        compress=CompressConfig(codec=args.codec))
    reqs = [Request(class_id=i % cfg.num_classes, rid=i)
            for i in range(args.requests)]
    splan = server.plan(args.steps)
    print(f"serving {len(reqs)} requests, schedule={args.schedule}, "
          f"{args.steps} steps, model={cfg.name}, device={server.device}"
          + (f", wire codec {args.codec}" if args.codec != "none" else ""))
    print(f"step plan: {splan.num_variants} variants for "
          f"{splan.num_steps} steps "
          f"({[len(splan.steps_of_variant(v)) for v in range(splan.num_variants)]}"
          f" steps each)")
    samples, stats = server.generate(reqs, num_steps=args.steps,
                                     guidance=args.guidance)
    print(f"samples: {tuple(samples.shape)}, "
          f"finite={bool(torch.isfinite(samples).all())}")
    for k, v in stats.items():
        if isinstance(v, list):
            v = f"[{v[0]:.6g} ... {v[-1]:.6g}] ({len(v)} steps)"
        elif isinstance(v, float):
            v = f"{v:.6g}"
        print(f"  {k:26s} {v}")


if __name__ == "__main__":
    main()
