"""Per-call time of ``EPMesh.all_to_all`` (the functional collective plus
``wait_tensor``) against ``dist.all_to_all_single`` into a preallocated
output, on two gloo ranks, alternating call by call, at phase 8c's
dispatch buffer and phase 17c's exchange.  Prints the median and the
quartiles of each route after 10 warm-up calls.

    python -m repro_torch.launch.time_a2a_routes [--device cuda|cpu] [--reps 200]
"""
from __future__ import annotations

import argparse
import statistics
import time

SHAPES = (("8c (2, 4, 320, 1152) f32", (2, 4, 320, 1152), "float32"),
          ("17c (2, 2560, 2048) bf16", (2, 2560, 2048), "bfloat16"))
WARMUP = 10


def _job(mesh, reps: int):
    import torch
    import torch.distributed as dist
    out = {}
    for name, shape, dtype in SHAPES:
        t = torch.randn(shape, device=mesh.device).to(getattr(torch, dtype))
        sync = torch.cuda.synchronize if t.is_cuda else (lambda: None)

        def plain():
            o = torch.empty_like(t)
            dist.all_to_all_single(o, t, group=mesh.group)
            return o

        routes = {"dist.all_to_all_single": plain, "EPMesh.all_to_all": lambda: mesh.all_to_all(t)}
        if not torch.equal(*(f() for f in routes.values())):
            raise AssertionError(f"{name}: the two routes disagree")
        times = {key: [] for key in routes}
        for i in range(reps):
            for key in (list(routes) if i % 2 == 0 else list(routes)[::-1]):
                sync()
                dist.barrier(group=mesh.group)
                t0 = time.perf_counter()
                routes[key]()
                sync()
                times[key].append((time.perf_counter() - t0) * 1e3)
        out[name] = times
    return out


def main(argv=None) -> None:
    from repro_torch.launch import mesh as mesh_lib
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)
    res, _ = mesh_lib.spawn(_job, 2, backend="gloo", device=args.device,
                            args=(args.reps,), timeout_s=300)
    for name, times in res.items():
        for key, xs in times.items():
            xs = sorted(xs[WARMUP:])
            q = statistics.quantiles(xs, n=4)
            print(f"{name} {key}: median {statistics.median(xs):.4f} ms, quartiles "
                  f"{q[0]:.4f} / {q[2]:.4f}, n {len(xs)}")


if __name__ == "__main__":
    main()
