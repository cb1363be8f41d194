#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines and seconds; any failure exits
non-zero and no phase's failure is caught:

  1. environment: the card's name and power limit, CUDA version, TF32 off;
  2. build: compiles the kernels under src/repro_torch/csrc with nvcc;
  3. kernels vs their plain PyTorch versions at the main path's shapes,
     with times, the roofline bound and (where one exists) a library call;
  4. kernels in place: the tiny model served on the CPU (plain versions)
     and on the card (kernels) from the same weights and noise, 6 steps
     so that a light step's codec'd expert outputs reach the sample;
  5. the main path: 8 DiT-MoE-XL requests x 10 steps under DICE with the
     int8 residual codec, then the other four schedules (sync, displaced
     and interweaved with the codec, staggered_batch) for 4 steps each;
     each run's kernel launch counts are set to 0 before it and held to
     what its plan implies after it.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit):
# FP32 outside the tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

TOL_F32 = dict(rtol=1e-4, atol=1e-4)      # f32 sums of up to 4608 terms
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)     # bf16 in/out, f32 accumulate
XL_STEPS = 10
TINY_STEPS = 6
XL_REQUESTS = 8


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    log(f"== phase {name}")
    yield
    log(f"== phase {name} done in {time.perf_counter() - t0:.3f} s")


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, by CUDA
    events after a warm-up call (inputs stay where the last call left them,
    so a working set under 50 MB is timed warm in L2)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare(name: str, got, want, tol) -> float:
    import torch
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bad = err > tol["atol"] + tol["rtol"] * w.abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    max_rel = float((err / w.abs().clamp_min(1e-6)).max()) if err.numel() else 0.0
    log(f"  {name}: max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} "
        f"(tol rtol={tol['rtol']} atol={tol['atol']}) "
        f"{'ok' if not bool(bad.any()) else 'FAIL'}")
    if bool(bad.any()) or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return max_abs


def bound(flops: float, nbytes: float):
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_environment():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmul and cuDNN")
    return smi.splitlines()[0]


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.3f} s "
        f"(nvcc {build.build_stats['seconds']:.3f} s) into {build.build_dir()}")
    for line in (build.build_dir() / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"  {line.strip()}")


def _expert_inputs(gen, E, C, d, f, dtype):
    import torch
    kw = dict(generator=gen, device="cuda")
    buf = torch.randn((E, C, d), **kw).to(dtype)
    wg = (torch.randn((E, d, f), **kw) / math.sqrt(d)).to(dtype)
    wu = (torch.randn((E, d, f), **kw) / math.sqrt(d)).to(dtype)
    wd = (torch.randn((E, f, d), **kw) / math.sqrt(f)).to(dtype)
    return buf, wg, wu, wd


def phase_kernels():
    """Each kernel against its plain version; returns the table rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = {}

    # ---- expert_ffn -------------------------------------------------------
    log("expert_ffn (hand-written CUDA, two launches) vs plain PyTorch")
    cases = [(8, 640, 1152, 4608, torch.float32, "silu"),   # XL refresh
             (8, 320, 1152, 4608, torch.float32, "silu"),   # XL DICE light
             (8, 640, 1152, 4608, torch.bfloat16, "silu"),
             (8, 320, 1152, 4608, torch.bfloat16, "silu"),
             (2, 136, 1152, 768, torch.float32, "gelu"),    # ragged C and f
             (2, 136, 64, 768, torch.bfloat16, "gelu")]
    for E, C, d, f, dtype, act in cases:
        args = _expert_inputs(gen, E, C, d, f, dtype)
        got = ops.expert_ffn(*args, act=act)
        want = ref.expert_ffn_ref(*args, act=act)
        torch.cuda.synchronize()
        err = compare(f"expert_ffn E={E} C={C} d={d} f={f} {str(dtype)[6:]} {act}",
                      got, want, TOL_F32 if dtype == torch.float32 else TOL_BF16)
        if (C, dtype) == (640, torch.float32):
            row_err, xl_args = err, args
    E, C, d, f = 8, 640, 1152, 4608
    ms = time_ms(lambda: ops.expert_ffn(*xl_args), 10)
    plain = time_ms(lambda: ref.expert_ffn_ref(*xl_args), 10)
    flops = 6.0 * E * C * d * f
    nbytes = 4.0 * (2 * E * C * d + 3 * E * d * f)
    b_ms, b_by = bound(flops, nbytes)
    log(f"  expert_ffn XL refresh f32: kernel {ms:.4f} ms ({flops / ms / 1e9:.2f} "
        f"TFLOP/s), plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"library: none (no single PyTorch call computes the gated MLP)")
    rows["expert_ffn"] = dict(
        name="expert_ffn", route="cuda", source="src/repro_torch/csrc/expert_ffn.cu",
        replaces="src/repro/kernels/expert_ffn.py:69", max_abs_err=row_err, ms=ms,
        plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape="E=8 C=640 d=1152 f=4608 f32 silu")
    del xl_args

    # ---- flash_attention --------------------------------------------------
    log("flash_attention (hand-written CUDA) vs plain PyTorch")
    fcases = [((8, 256, 256, 16, 16, 72), torch.float32, {}),    # XL DiT
              ((8, 256, 256, 16, 16, 72), torch.bfloat16, {}),
              ((2, 128, 128, 4, 2, 64), torch.float32, dict(causal=True)),
              ((2, 128, 128, 4, 2, 64), torch.float32, dict(window=64)),
              ((2, 128, 128, 4, 2, 64), torch.float32, dict(causal=True, window=32)),
              ((2, 128, 128, 4, 2, 64), torch.float32, dict(softcap=50.0)),
              ((2, 128, 128, 4, 2, 64), torch.float32,
               dict(causal=True, window=64, softcap=30.0)),
              ((1, 256, 256, 4, 1, 64), torch.float32, {}),             # MQA
              ((2, 64, 64, 2, 2, 128), torch.float32, {}),
              ((2, 128, 256, 8, 8, 32), torch.float32, {}),
              ((1, 64, 100, 2, 2, 256), torch.float32, dict(causal=True)),  # ragged Sk
              ((1, 40, 40, 2, 2, 24), torch.float32, dict(window=1))]
    for (B, Sq, Sk, H, KVH, Dh), dtype, opts in fcases:
        q = torch.randn((B, Sq, H, Dh), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, Sk, KVH, Dh), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, Sk, KVH, Dh), generator=gen, device="cuda").to(dtype)
        got = ops.flash_attention(q, k, v, **opts)
        want = ref.flash_attention_ref(q, k, v, **opts)
        torch.cuda.synchronize()
        err = compare(f"flash B={B} Sq={Sq} Sk={Sk} H={H} KVH={KVH} Dh={Dh} "
                      f"{str(dtype)[6:]} {opts}", got, want,
                      TOL_F32 if dtype == torch.float32 else TOL_BF16)
        if (Dh, dtype) == (72, torch.float32):
            row_err, xl_qkv = err, (q, k, v)
    q, k, v = xl_qkv
    B, S, H, Dh = q.shape
    ms = time_ms(lambda: ops.flash_attention(q, k, v), 50)
    plain = time_ms(lambda: ref.flash_attention_ref(q, k, v), 50)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 50)
    flops = 4.0 * B * H * S * S * Dh
    nbytes = 4.0 * 4 * B * S * H * Dh
    b_ms, b_by = bound(flops, nbytes)
    log(f"  flash XL f32: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"scaled_dot_product_attention {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    rows["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:70", max_abs_err=row_err,
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        shape="B=8 S=256 H=16 Dh=72 f32 non-causal")

    # ---- residual_int8 ----------------------------------------------------
    log("residual_int8 (hand-written CUDA) vs plain PyTorch")
    for N, dtype in ((2048, torch.float32), (4096, torch.float32),
                     (4096, torch.bfloat16)):
        d = 1152
        value = torch.randn((N, d), generator=gen, device="cuda").to(dtype)
        base = (value.float() + 0.1 * torch.randn((N, d), generator=gen,
                                                 device="cuda")).to(dtype)
        # exact .5 ties: base 0 and a row abs-max of 127 give scale 1, so
        # r / scale lands on k + 0.5, which must round half to even
        ties = torch.arange(d, device="cuda", dtype=torch.float32) % 254 - 126.5
        ties[0] = 127.0
        value[:64] = ties.to(dtype)
        base[:64] = 0
        qk, sk, rk = ops.residual_int8(value, base)
        qp, sp, rp = ref.residual_int8_ref(value, base)
        torch.cuda.synchronize()
        mism = int((qk != qp).sum())
        log(f"  residual_int8 N={N} d={d} {str(dtype)[6:]}: q mismatches {mism} "
            f"(tol 0), tie rows round half to even: "
            f"{bool((qk[:64].float() == torch.round(ties)[None]).all())}")
        if mism or not torch.equal(sk, sp):
            raise AssertionError("residual_int8: q or scale differ from the plain version")
        err = compare(f"residual_int8 recon N={N} {str(dtype)[6:]}", rk, rp,
                      dict(rtol=1e-6, atol=1e-6) if dtype == torch.float32 else TOL_BF16)
        if (N, dtype) == (4096, torch.float32):
            row_err, xl_vb = err, (value, base)
    value, base = xl_vb
    N, d = value.shape
    ms = time_ms(lambda: ops.residual_int8(value, base), 100)
    plain = time_ms(lambda: ref.residual_int8_ref(value, base), 100)
    nbytes = N * d * (4 + 4 + 1 + 4) + N * 4
    b_ms, b_by = bound(6.0 * N * d, nbytes)
    log(f"  residual_int8 N=4096 d=1152 f32: kernel {ms:.4f} ms "
        f"({nbytes / ms / 1e6:.1f} GB/s), plain {plain:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}), library: none")
    rows["residual_int8"] = dict(
        name="residual_int8", route="cuda", source="src/repro_torch/csrc/residual_int8.cu",
        replaces="src/repro/kernels/residual_codec.py:44", max_abs_err=row_err, ms=ms,
        plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape="N=4096 d=1152 f32")
    torch.cuda.synchronize()
    return rows


def _perturb(params, gen, scale=0.05):
    """adaLN and the output layer are zero-initialised; give them random
    values so the blocks are not identity maps."""
    import torch
    dev = gen.device
    for blk in params["blocks"]:
        blk["adaln"] = scale * torch.randn(blk["adaln"].shape, generator=gen, device=dev)
    params["final_out"] = scale * torch.randn(params["final_out"].shape,
                                              generator=gen, device=dev)
    return params


def planned_launches(splan, cfg, passes: int):
    """Kernel launches the plan implies: per pass and layer one flash
    attention and one expert FFN (two for a staggered half-batch layer);
    a codec'd action quantizes its dispatch payload, and an interweaved
    one with a cache its combine payload too."""
    n = {"expert_ffn": 0, "flash_attention": 0, "residual_int8": 0}
    for plan in splan.steps:
        for a in plan.actions:
            n["flash_attention"] += passes
            n["expert_ffn"] += passes * (2 if a.mode == "staggered" else 1)
            if a.codec is not None:
                n["residual_int8"] += passes * (
                    1 + int(a.mode == "interweaved" and a.want_cache))
    return n


def phase_tiny():
    import torch
    from repro_torch.compress.codecs import CompressConfig
    from repro_torch.configs.dit_moe_xl import tiny
    from repro_torch.core.schedules import DiceConfig
    from repro_torch.launch.serve import DiceServer, Request
    from repro_torch.models.dit_moe import init_dit
    cfg = tiny()
    gen = torch.Generator(device="cpu").manual_seed(5)
    params = _perturb(init_dit(cfg, generator=gen), gen)
    noise = torch.randn((8, cfg.patch_tokens, cfg.in_channels), generator=gen)
    reqs = [Request(class_id=i % cfg.num_classes, rid=i) for i in range(8)]
    dcfg = DiceConfig.dice(compress=CompressConfig("int8_residual"))
    out = {}
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else _to(params, dev)
        server = DiceServer(cfg, dcfg, params=p, device=dev)
        # 6 steps: warm-up 0-1, refresh 2 and 4, light 3 and 5.  Step 4
        # consumes the light step's (int8-coded) expert outputs; with 4
        # steps they would never reach the sample.
        out[dev], stats = server.generate(reqs, num_steps=TINY_STEPS, noise=noise)
        log(f"  tiny on {dev}: {stats['wall_s']:.3f} s, launches "
            f"{stats['kernel_launches']}")
    if min(stats["kernel_launches"].values()) <= 0:
        raise AssertionError("the CUDA run of the tiny model missed a kernel")
    # f32 sums in another order can flip an int8 rounding (one quantization
    # step, 1/127 of a row's residual range); such flips stay far below
    # 1e-3 in the sample, while a wrong kernel's errors are O(1)
    compare("tiny dice+int8 samples, cuda kernels vs cpu plain", out["cuda"].cpu(),
            out["cpu"], dict(rtol=1e-3, atol=1e-3))


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def drive(server, reqs, num_steps: int, label: str, *, need_codec: bool):
    """One ``generate`` call with the launch counts set to 0 just before it
    and read just after; the counts must equal what the plan implies, and
    every kernel the path runs must have been launched."""
    import torch
    from repro_torch.kernels import ops
    splan = server.plan(num_steps)
    ops.reset_launches()
    samples, stats = server.generate(reqs, num_steps=num_steps)
    counts = dict(ops.LAUNCHES)
    want = planned_launches(splan, server.cfg, passes=2)
    finite = bool(torch.isfinite(samples).all())
    log(f"  {label} XL {len(reqs)} requests x {num_steps} steps: "
        f"{stats['wall_s_per_step']:.4f} s/step, finite {finite}, std "
        f"{float(samples.std()):.6f}, launches {counts}, planned {want}")
    cfg = server.cfg
    if not finite or tuple(samples.shape) != (len(reqs), cfg.patch_tokens,
                                              cfg.in_channels):
        raise AssertionError(f"{label}: samples are not finite or have the wrong shape")
    needed = ["expert_ffn", "flash_attention"] + ["residual_int8"] * need_codec
    if counts != want or min(counts[k] for k in needed) <= 0:
        raise AssertionError(f"{label}: kernel launch counts differ from the plan")
    return samples, stats, counts


def phase_xl(rows):
    import torch
    from repro_torch.bridge import leaves
    from repro_torch.compress.codecs import CompressConfig
    from repro_torch.configs.dit_moe_xl import config
    from repro_torch.core.schedules import DiceConfig
    from repro_torch.launch.serve import DiceServer, Request
    cfg = config()
    int8 = CompressConfig("int8_residual")
    t0 = time.perf_counter()
    server = DiceServer(cfg, DiceConfig.dice(compress=int8), device="cuda", seed=0)
    _perturb(server.params, torch.Generator(device="cuda").manual_seed(99))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(server.params).values())
    log(f"  XL params: {n_params / 1e9:.3f} B on the card, init {time.perf_counter() - t0:.3f} s")
    reqs = [Request(class_id=(37 * i) % cfg.num_classes, rid=i)
            for i in range(XL_REQUESTS)]
    server.generate(reqs, num_steps=1)            # warm-up: cuBLAS, allocator
    torch.cuda.reset_peak_memory_stats()
    samples, stats, counts = drive(server, reqs, XL_STEPS, "dice+int8",
                                   need_codec=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  dice+int8 wall {stats['wall_s']:.4f} s, peak memory {peak:.3f} GiB, "
        f"plan variants {stats['num_plan_variants']}")
    db = stats["dispatch_bytes_per_step"]
    refresh = [db[s] for s in range(XL_STEPS) if s >= 2 and s % 2 == 0]
    light = [db[s] for s in range(XL_STEPS) if s >= 2 and s % 2 == 1]
    log(f"  dispatch_bytes per step {db}: refresh {refresh[0]:.0f}, light {light[0]:.0f}")
    if not max(light) < min(refresh):
        raise AssertionError("light steps do not dispatch fewer bytes than refresh steps")
    for name, row in rows.items():
        row["launches"] = counts[name]

    # the other four schedules, 4 steps each from the same weights: 2
    # warm-up steps, then a refresh and a light (codec'd) step
    others = {"sync": (DiceConfig.sync_ep(), False),
              "displaced+int8": (DiceConfig.displaced(compress=int8), True),
              "interweaved+int8": (DiceConfig.interweaved(compress=int8), True),
              "staggered_batch": (DiceConfig.staggered_batch(), False)}
    for label, (dcfg, need_codec) in others.items():
        other = DiceServer(cfg, dcfg, params=server.params, device="cuda")
        drive(other, reqs, 4, label, need_codec=need_codec)


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              f"(no src/repro_torch beside this script)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    with phase("1 environment"):
        smi = phase_environment()
    with phase("2 build"):
        phase_build()
    with phase("3 kernels vs plain versions"):
        rows = phase_kernels()
    with phase("4 kernels in place (tiny, cpu vs cuda)"):
        phase_tiny()
    with phase("5 main path (DiT-MoE-XL, dice + int8_residual; other schedules)"):
        phase_xl(rows)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: rows[n][k] for k in keys} for n in rows]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
