"""The port's CUDA kernels on the card: each against its plain PyTorch
version, its launch counter, and the wrapper's input checks.

Every test here needs a CUDA device and is marked ``cuda``; without one it
skips.  This file imports neither JAX nor the JAX package, so it runs on a
machine with only PyTorch:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the shared conftest imports JAX.)  Tolerances: f32
1e-4 (sums of up to a few thousand terms in another order than cuBLAS'),
bf16 2e-2; the int8 codec's q and scale must agree exactly; the RWKV-6
recurrence 1e-3 (f32 state and output, sums of DK terms chained over T).
"""
import math

import pytest
import torch

from repro_torch.kernels import build, ops, ref

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _launched(name, fn):
    before = ops.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == before + 1
    return out


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def _expert_inputs(gen, E, C, d, f, dtype):
    kw = dict(generator=gen, device="cuda")
    return ((torch.randn((E, C, d), **kw)).to(dtype),
            (torch.randn((E, d, f), **kw) / math.sqrt(d)).to(dtype),
            (torch.randn((E, d, f), **kw) / math.sqrt(d)).to(dtype),
            (torch.randn((E, f, d), **kw) / math.sqrt(f)).to(dtype))


# after the first four: edges of the 128-row, BK = 32, 64/128-column tiles
# (one row, rows one short of and one past a block, d not a multiple of
# 32, ragged f, rows not 16-byte aligned) and the XL light and refresh shapes
@pytest.mark.parametrize("E,C,d,f", [(2, 16, 64, 128), (8, 32, 64, 96),
                                     (2, 136, 64, 768), (1, 8, 72, 100),
                                     (8, 1, 72, 100), (8, 127, 1000, 100),
                                     (8, 129, 72, 4608), (2, 5, 30, 50),
                                     (8, 320, 1152, 4608), (8, 640, 1152, 4608)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_expert_ffn_kernel(gen, E, C, d, f, dtype, act):
    buf, wg, wu, wd = _expert_inputs(gen, E, C, d, f, dtype)
    got = _launched("expert_ffn", lambda: ops.expert_ffn(buf, wg, wu, wd, act=act))
    assert got.dtype == dtype and got.shape == buf.shape
    _close(got, ref.expert_ffn_ref(buf, wg, wu, wd, act=act), dtype)


def test_expert_ffn_kernel_reads_unaligned_base(gen):
    """Contiguous views whose data start 4 bytes past a 16-byte boundary:
    the tiles are loaded element by element."""
    E, C, d, f = 2, 40, 64, 96
    args = _expert_inputs(gen, E, C, d, f, torch.float32)
    views = []
    for a in args:
        flat = torch.empty(a.numel() + 1, device="cuda")
        view = flat[1:].view(a.shape)
        view.copy_(a)
        assert view.is_contiguous() and view.data_ptr() % 16 == 4
        views.append(view)
    got = _launched("expert_ffn", lambda: ops.expert_ffn(*views))
    _close(got, ref.expert_ffn_ref(*args), torch.float32)


# after the first six: edges of the 128-row query and 32-key (16 at
# Dh > 128) K/V tiles: Dh 24/72/128/256, ragged Sk, Sq not a multiple of
# 64, GQA and MQA, and the DiT-MoE-XL shape
@pytest.mark.parametrize("shape,opts", [
    ((2, 64, 64, 4, 4, 72), {}),
    ((2, 128, 128, 4, 2, 64), dict(causal=True)),
    ((2, 128, 128, 4, 2, 64), dict(window=64)),
    ((2, 128, 128, 4, 2, 64), dict(causal=True, window=64, softcap=30.0)),
    ((1, 64, 100, 4, 1, 32), {}),                  # MQA, ragged key tile
    ((1, 16, 16, 2, 2, 256), dict(causal=True, window=0)),   # all masked
    ((2, 40, 100, 4, 2, 24), {}),
    ((2, 65, 257, 4, 1, 72), {}),                  # MQA
    ((8, 256, 256, 16, 16, 72), {}),
    ((1, 65, 257, 8, 2, 128), dict(causal=True)),
    ((1, 40, 257, 4, 2, 256), dict(window=48)),
    ((2, 65, 100, 4, 4, 128), dict(softcap=20.0)),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(gen, shape, opts, dtype):
    B, Sq, Sk, H, KVH, Dh = shape
    kw = dict(generator=gen, device="cuda")
    q = torch.randn((B, Sq, H, Dh), **kw).to(dtype)
    k = torch.randn((B, Sk, KVH, Dh), **kw).to(dtype)
    v = torch.randn((B, Sk, KVH, Dh), **kw).to(dtype)
    got = _launched("flash_attention", lambda: ops.flash_attention(q, k, v, **opts))
    _close(got, ref.flash_attention_ref(q, k, v, **opts), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_reads_unaligned_rows(gen, dtype):
    """Dh = 30 sliced one element into a 31-wide tensor: no row is 16-byte
    aligned, so q, k and v are loaded element by element."""
    base = torch.randn((2, 70, 3, 4, 31), generator=gen, device="cuda").to(dtype)
    q, k, v = base[..., 1:].unbind(2)
    assert q.stride(-1) == 1 and k.data_ptr() % 16 != 0
    got = _launched("flash_attention", lambda: ops.flash_attention(q, k, v, causal=True))
    _close(got, ref.flash_attention_ref(q, k, v, causal=True), dtype)


@pytest.mark.parametrize("kernel", ["expert_ffn", "flash_attention"])
def test_one_tf32_pass_misses_the_f32_tolerance(gen, monkeypatch, kernel):
    """The 3xTF32 split is what holds the f32 kernels to 1e-4: the same
    sources built with -DDICE_TF32_ONE_PASS (one TF32 pass a product) miss
    it at the DiT-MoE-XL contraction lengths (d = 1152, f = 4608; Dh = 72)."""
    if kernel == "expert_ffn":
        args = _expert_inputs(gen, 2, 64, 1152, 4608, torch.float32)
        run, plain = ops.expert_ffn, ref.expert_ffn_ref
    else:
        args = tuple(torch.randn((2, 128, 4, 72), generator=gen, device="cuda")
                     for _ in range(3))
        run, plain = ops.flash_attention, ref.flash_attention_ref
    want = plain(*args)
    _close(_launched(kernel, lambda: run(*args)), want, torch.float32)
    one_pass = build.library(("DICE_TF32_ONE_PASS",))
    monkeypatch.setattr(ops, "library", lambda: one_pass)
    got = _launched(kernel, lambda: run(*args))
    with pytest.raises(AssertionError):
        _close(got, want, torch.float32)


def test_flash_attention_reads_strided_inputs(gen):
    """q/k/v sliced out of one fused projection: no copy is made."""
    qkv = torch.randn((2, 64, 3, 4, 32), generator=gen, device="cuda")
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    got = _launched("flash_attention", lambda: ops.flash_attention(q, k, v))
    _close(got, ref.flash_attention_ref(q, k, v), torch.float32)


# the register path's widths (d = 1152 at N = 4096 and 8192, the XL
# dispatch and combine payloads; 4096 is its widest bf16 row), and the
# looping path's rows: d not a multiple of the 16-byte vector (1151, 1150
# in bf16), wider than 16 vectors a lane (4096 f32, 8192, 9000); N not a
# multiple of the 8 rows a block
@pytest.mark.parametrize("N,d", [(64, 1152), (33, 96), (4096, 1152), (8192, 1152),
                                 (37, 1151), (9, 1150), (16, 4096), (16, 8192),
                                 (5, 9000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_residual_int8_kernel(gen, N, d, dtype):
    value = torch.randn((N, d), generator=gen, device="cuda")
    base = value + 0.1 * torch.randn((N, d), generator=gen, device="cuda")
    ties = torch.arange(d, device="cuda", dtype=torch.float32) % 254 - 126.5
    ties[0] = 127.0
    value[:4], base[:4] = ties, 0.0
    value, base = value.to(dtype), base.to(dtype)
    q, s, r = _launched("residual_int8", lambda: ops.residual_int8(value, base))
    qp, sp, rp = ref.residual_int8_ref(value, base)
    assert torch.equal(q, qp) and torch.equal(s, sp)
    assert torch.equal(q[0].float(), torch.round(ties))
    _close(r, rp, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_residual_int8_reads_unaligned_rows(gen, dtype):
    """Contiguous (N, d) views that start 1 element into their storage: the
    rows are not 16-byte aligned, so the looping path takes them."""
    N, d = 40, 1152
    flat = torch.randn(2 * N * d + 1, generator=gen, device="cuda").to(dtype)
    value = flat[1:1 + N * d].view(N, d)
    base = flat[1 + N * d:].view(N, d)
    assert value.data_ptr() % 16 and base.data_ptr() % 16 and base.is_contiguous()
    q, s, r = _launched("residual_int8", lambda: ops.residual_int8(value, base))
    qp, sp, rp = ref.residual_int8_ref(value, base)
    assert torch.equal(q, qp) and torch.equal(s, sp)
    _close(r, rp, dtype)


def _nonfinite_rows(value, base):
    """NaN, +Inf, -Inf and a mix in the first rows of the payload, and a
    NaN in the base of the fifth."""
    d = value.shape[1]
    value[0, 3] = math.nan
    value[1, 2] = math.inf
    value[2, d - 1] = -math.inf
    value[3, 1], value[3, d // 2], value[3, d - 2] = math.nan, math.inf, -math.inf
    base[4, 0] = math.nan


# C.6: the register path (d = 1152, and 4096 bf16) and the looping path
# (d = 1151, and rows wider than the registers hold)
@pytest.mark.parametrize("N,d", [(33, 1152), (9, 1151), (16, 4096), (5, 9000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_residual_int8_kernel_on_non_finite_rows(gen, N, d, dtype):
    """A row holding NaN or Inf: the kernel gives its plain version's (and
    the JAX encoder's) scale NaN or Inf, q 0 and a NaN reconstruction,
    where fmaxf would have dropped the NaN and quantized it to -127."""
    value = torch.randn((N, d), generator=gen, device="cuda")
    base = value + 0.1 * torch.randn((N, d), generator=gen, device="cuda")
    _nonfinite_rows(value, base)
    value, base = value.to(dtype), base.to(dtype)
    q, s, r = _launched("residual_int8", lambda: ops.residual_int8(value, base))
    qp, sp, rp = ref.residual_int8_ref(value, base)
    assert torch.equal(q, qp)
    torch.testing.assert_close(s, sp, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(torch.isnan(r), torch.isnan(rp))
    assert bool(torch.isnan(r[:5]).all()) and bool((q[:5] == 0).all())
    _close(r[5:], rp[5:], dtype)


def test_kernels_keep_a_nan_row_where_their_plain_versions_do(gen):
    """expert_ffn: a NaN buffer row stays in its own output row (rows are
    independent in the grouped GEMM).  flash_attention: a NaN key reaches
    every query of its batch entry, on both sides."""
    buf, wg, wu, wd = _expert_inputs(gen, 8, 40, 72, 100, torch.float32)
    buf[2, 7, 5] = math.nan
    got = _launched("expert_ffn", lambda: ops.expert_ffn(buf, wg, wu, wd))
    want = ref.expert_ffn_ref(buf, wg, wu, wd)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert bool(torch.isnan(got[2, 7]).all())
    assert int(torch.isnan(got).sum()) == got.shape[-1]
    _close(torch.nan_to_num(got, nan=0.0), torch.nan_to_num(want, nan=0.0),
           torch.float32)
    q, k, v = (torch.randn((2, 64, 4, 72), generator=gen, device="cuda")
               for _ in range(3))
    k[1, 10, 2, 3] = math.nan
    got = _launched("flash_attention", lambda: ops.flash_attention(q, k, v))
    want = ref.flash_attention_ref(q, k, v)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert bool(torch.isnan(got[1, :, 2]).all())
    _close(got[0], want[0], torch.float32)


SCAN_TOL = dict(rtol=1e-3, atol=1e-3)


def _scan_inputs(gen, B, H, T, DK, dtype, logw_dtype=torch.float32):
    kw = dict(generator=gen, device="cuda")
    r, k, v = (torch.randn((B, H, T, DK), **kw).to(dtype) for _ in range(3))
    logw = (-torch.exp(torch.randn((B, H, T, DK), **kw))).to(logw_dtype)
    u = (0.5 + 0.1 * torch.randn((H, DK), **kw)).to(dtype)
    s0 = 0.1 * torch.randn((B, H, DK, DK), **kw)
    return r, k, v, logw, u, s0


# T across the staged tiles (512 / DK steps: 1, a ragged last tile at 37
# and 300, whole tiles at 256); B * H = 6 blocks, one per (b, h)
@pytest.mark.parametrize("DK", [16, 32, 64, 128])
@pytest.mark.parametrize("T", [1, 37, 256, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_scan_kernel(gen, DK, T, dtype):
    args = _scan_inputs(gen, 2, 3, T, DK, dtype)
    out, s_T = _launched("rwkv6_scan", lambda: ops.rwkv6_scan(*args))
    want_out, want_s = ref.rwkv6_scan_ref(*args)
    assert out.dtype == torch.float32 and s_T.dtype == torch.float32
    torch.testing.assert_close(out, want_out, **SCAN_TOL)
    torch.testing.assert_close(s_T, want_s, **SCAN_TOL)


def test_rwkv6_scan_kernel_takes_logw_in_the_input_dtype_and_dk_128(gen):
    args = _scan_inputs(gen, 1, 2, 40, 128, torch.bfloat16, torch.bfloat16)
    out, s_T = _launched("rwkv6_scan", lambda: ops.rwkv6_scan(*args))
    want_out, want_s = ref.rwkv6_scan_ref(*args)
    torch.testing.assert_close(out, want_out, **SCAN_TOL)
    torch.testing.assert_close(s_T, want_s, **SCAN_TOL)


def test_rwkv6_scan_reads_strided_inputs(gen):
    """(B, T, H, DK) projections permuted to (B, H, T, DK), as the model
    passes them: no copy is made."""
    B, T, H, DK = 2, 33, 4, 64
    kw = dict(generator=gen, device="cuda")
    rkv = torch.randn((B, T, 3, H, DK), **kw).to(torch.bfloat16)
    r, k, v = (a.permute(0, 2, 1, 3) for a in rkv.unbind(2))
    logw = (-torch.exp(torch.randn((B, T, H, DK), **kw))).permute(0, 2, 1, 3)
    u = torch.full((H, DK), 0.5, device="cuda", dtype=torch.bfloat16)
    s0 = torch.zeros((B, H, DK, DK), device="cuda")
    assert not r.is_contiguous() and not logw.is_contiguous()
    out, s_T = _launched("rwkv6_scan", lambda: ops.rwkv6_scan(r, k, v, logw, u, s0))
    want_out, want_s = ref.rwkv6_scan_ref(r, k, v, logw, u, s0)
    torch.testing.assert_close(out, want_out, **SCAN_TOL)
    torch.testing.assert_close(s_T, want_s, **SCAN_TOL)


@pytest.mark.parametrize("DK", [16, 64, 128])
def test_rwkv6_scan_reads_unaligned_rows(gen, DK):
    """r/k/v and logw cut out of wider rows one element in, with odd time
    strides: no row is 16-byte aligned, so the tiles are copied element by
    element; B * H = 15 (3 x 5)."""
    B, T, H = 3, 45, 5
    kw = dict(generator=gen, device="cuda")
    width = H * DK
    rkv = torch.randn((B, T, 3 * width + 3), **kw).to(torch.bfloat16)
    r, k, v = (rkv[..., 1 + i * width:1 + (i + 1) * width].unflatten(-1, (H, DK))
               .permute(0, 2, 1, 3) for i in range(3))
    w = -torch.exp(torch.randn((B, T, width + 1), **kw) - 2.0)
    logw = w[..., 1:].unflatten(-1, (H, DK)).permute(0, 2, 1, 3)
    u = (0.5 + 0.1 * torch.randn((H, DK), **kw)).to(torch.bfloat16)
    s0 = 0.1 * torch.randn((B, H, DK, DK), **kw)
    assert r.data_ptr() % 16 and logw.data_ptr() % 16
    out, s_T = _launched("rwkv6_scan", lambda: ops.rwkv6_scan(r, k, v, logw, u, s0))
    want_out, want_s = ref.rwkv6_scan_ref(r, k, v, logw, u, s0)
    torch.testing.assert_close(out, want_out, **SCAN_TOL)
    torch.testing.assert_close(s_T, want_s, **SCAN_TOL)


def test_rwkv6_scan_refuses_what_the_kernel_does_not_take(gen):
    r, k, v, logw, u, s0 = _scan_inputs(gen, 1, 2, 4, 16, torch.bfloat16)
    with pytest.raises(TypeError):                    # r/k/v in float64
        ops.rwkv6_scan(r.double(), k.double(), v.double(), logw, u, s0)
    with pytest.raises(TypeError):                    # mixed r/k/v
        ops.rwkv6_scan(r, k.float(), v, logw, u, s0)
    with pytest.raises(TypeError):                    # logw in float16
        ops.rwkv6_scan(r, k, v, logw.half(), u, s0)
    with pytest.raises(TypeError):                    # state not f32
        ops.rwkv6_scan(r, k, v, logw, u, s0.to(torch.bfloat16))
    with pytest.raises(ValueError):                   # u on another device
        ops.rwkv6_scan(r, k, v, logw, u.cpu(), s0)
    with pytest.raises(ValueError):                   # DK the kernel lacks
        a = _scan_inputs(gen, 1, 2, 4, 24, torch.float32)
        ops.rwkv6_scan(*a)
    with pytest.raises(ValueError):                   # last dim strided
        rt = r.transpose(2, 3).contiguous().transpose(2, 3)
        ops.rwkv6_scan(rt, rt, rt, logw, u, s0)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x = torch.randn((2, 8, 16), generator=gen, device="cuda")
    w = torch.randn((2, 16, 32), generator=gen, device="cuda")
    wd = torch.randn((2, 32, 16), generator=gen, device="cuda")
    with pytest.raises(TypeError):
        ops.expert_ffn(x.double(), w.double(), w.double(), wd.double())
    with pytest.raises(ValueError):
        ops.expert_ffn(x, w, w, wd.transpose(1, 2).contiguous())
    with pytest.raises(ValueError):                   # not contiguous
        ops.expert_ffn(torch.randn((2, 16, 8), device="cuda").transpose(1, 2),
                       w, w, wd)
    with pytest.raises(ValueError):
        ops.expert_ffn(x, w.cpu(), w, wd)
    q = torch.randn((1, 8, 2, 300), generator=gen, device="cuda")
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q)                  # head_dim over 256
    with pytest.raises(ValueError):
        ops.residual_int8(x[0], x[1].t())


def _to_cuda(tree):
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cuda(v) for v in tree]
    return tree.cuda()


@pytest.mark.parametrize("steps", [4, 6])
@pytest.mark.parametrize("schedule", ["sync", "interweaved", "dice", "dice_int8"])
def test_recycled_slot_equals_fresh_batch_on_the_card(gen, schedule, steps):
    """Continuous batching on the card: rid 2 is admitted into a recycled
    slot, and its sample and the first wave's equal the same requests in a
    fresh fixed batch bit for bit (the 4-layer config of
    tests/test_serve_continuous.py; capacity_factor 8.0, so no overflow).
    At 6 steps a light step's output reaches the sample; at 4 it does not."""
    from repro_torch.compress.codecs import CompressConfig
    from repro_torch.configs.dit_moe_xl import tiny
    from repro_torch.core.schedules import DiceConfig
    from repro_torch.launch.serve import (DiceServer, Request, request_noise,
                                          serve_continuous)
    from repro_torch.models.dit_moe import init_dit
    cfg = tiny().replace(num_layers=4, d_model=64, moe_d_ff=64, d_ff=256,
                         patch_tokens=16, capacity_factor=8.0)
    cpu = torch.Generator().manual_seed(99)
    params = init_dit(cfg, generator=cpu)
    for blk in params["blocks"]:
        blk["adaln"] = 0.05 * torch.randn(blk["adaln"].shape, generator=cpu)
    params["final_out"] = 0.05 * torch.randn(params["final_out"].shape,
                                             generator=cpu)
    params = _to_cuda(params)
    dcfg = {"sync": DiceConfig.sync_ep(), "interweaved": DiceConfig.interweaved(),
            "dice": DiceConfig.dice(),
            "dice_int8": DiceConfig.dice(
                compress=CompressConfig("int8_residual"))}[schedule]
    server = DiceServer(cfg, dcfg, params=params, device="cuda")
    reqs = [Request(1, 0), Request(2, 1), Request(3, 2)]
    before = dict(ops.LAUNCHES)
    out, stats = serve_continuous(server, reqs, max_batch=2, num_steps=steps,
                                  seed=42, arrival_steps=[0.0, 0.0, 1.0])
    assert stats["recycled_admissions"] >= 1
    assert stats["step_keys"] == stats["num_plan_variants"]
    assert ops.LAUNCHES["expert_ffn"] > before["expert_ffn"]

    def fresh(batch):
        noise = torch.stack([request_noise(42, r.rid, cfg, "cuda")
                             for r in batch])
        x, _ = server.generate(batch, num_steps=steps, noise=noise)
        return {r.rid: x[i].cpu() for i, r in enumerate(batch)}
    ref = {**fresh([reqs[2], Request(5, 7)]), **fresh(reqs[:2])}
    for rid in (0, 1, 2):
        assert torch.equal(out[rid], ref[rid]), rid


@pytest.mark.parametrize("case", ["equal", "saturated"])
def test_route_breaks_ties_like_jax_top_k_on_the_card(gen, case):
    """The card's stable sort keeps the lowest expert id first among equal
    probabilities, as ``jax.lax.top_k`` does (ROADMAP C.1): all 8 equal,
    or a softmax saturated by a bias of 200 on expert 0."""
    from repro_torch.configs.dit_moe_xl import tiny
    from repro_torch.core import moe
    cfg = tiny().replace(num_experts=8, experts_per_token=2)
    x = torch.randn((64, 16), generator=gen, device="cuda")
    p = {"router": torch.zeros((16, 8), device="cuda")}
    if case == "saturated":
        p["router"] = torch.randn((16, 8), generator=gen, device="cuda")
        p["router_bias"] = torch.zeros(8, device="cuda")
        p["router_bias"][0] = 200.0
    _, scores, idx = moe.route(p, x, cfg)
    assert (idx.cpu() == torch.tensor([0, 1])).all()
    _, cpu_scores, cpu_idx = moe.route({k: v.cpu() for k, v in p.items()},
                                       x.cpu(), cfg)
    assert torch.equal(idx.cpu(), cpu_idx)


def test_gloo_transports_take_cuda_tensors(gen):
    """Two gloo ranks sharing the card, the pairing of ``chip_smoke.py``'s
    phase 8: the mesh's collectives take CUDA tensors as they are, and a
    ring hop, whose send/recv gloo takes from host memory only, arrives
    through the pinned staging of ``EPMesh.exchange``.  Each spawned rank
    and its collectives time out after 120 s, so a hang fails the test."""
    import torch_ep_jobs as jobs
    from repro_torch.launch import mesh as mesh_lib
    every_rank, _ = mesh_lib.spawn(jobs.mesh_transports, 2,
                                   backend="gloo", device="cuda",
                                   timeout_s=120)
    for r, ok in enumerate(every_rank):
        assert all(ok.values()), (r, ok)


def _plain_displaced(q, k, v, k_prev, v_prev, n_dev):
    """The owner-p math of displaced patch attention, one plain attention
    call per owner over the whole query range, each owner's rows kept."""
    from repro_torch.core.patch_parallel import shard_owner
    S = q.shape[1]
    owner = shard_owner(S, n_dev, device=q.device)
    out = torch.empty_like(q)
    for p in range(n_dev):
        sel = (owner == p)[None, :, None, None]
        o = ref.flash_attention_ref(q, torch.where(sel, k, k_prev),
                                    torch.where(sel, v, v_prev))
        out[:, owner == p] = o[:, owner == p]
    return out


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_displaced_patch_attention_through_the_kernel(gen, n_dev):
    """DistriFusion's replicated simulation at XL's shapes (B 8, S 256, 16
    heads x 72): n_dev flash launches of S / n_dev queries against the
    spliced stale K/V, against the plain per-owner math."""
    from repro_torch.core.patch_parallel import (PatchParallelState,
                                                 displaced_patch_attention)
    B, S, H, Dh = 8, 256, 16, 72
    q, k, v, kp, vp = (torch.randn((B, S, H, Dh), generator=gen, device="cuda")
                       for _ in range(5))
    before = ops.LAUNCHES["flash_attention"]
    out, new = displaced_patch_attention(q, k, v, PatchParallelState(kp, vp),
                                         n_dev=n_dev, warmup=False)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + n_dev
    _close(out, _plain_displaced(q, k, v, kp, vp, n_dev), torch.float32)
    assert new.k_prev is k and new.v_prev is v
    warm, _ = displaced_patch_attention(q, k, v, PatchParallelState(kp, vp),
                                        n_dev=n_dev, warmup=True)
    _close(warm, ref.flash_attention_ref(q, k, v), torch.float32)


class _OnePatchGroup:
    """Rank ``p`` of a patch axis whose all-gather returns every rank's
    stacked K/V shards (given), as the mesh's gloo group would."""

    def __init__(self, p, P, shards):
        self.p, self.patch_size, self.shards = p, P, shards

    def rank_in(self, axis):
        return self.p if axis == "patch" else 0

    def patch_all_gather(self, t):
        return torch.cat(self.shards)


@pytest.mark.parametrize("P", [2, 4, 8])
def test_sharded_patch_attention_through_the_kernel(gen, P):
    """One rank's sharded patch attention at XL's shapes: T_loc = S / P
    queries against S keys in one launch, rows mixed fresh and stale,
    against the plain per-owner math of the displaced simulation."""
    from repro_torch.core.patch_parallel import (PatchParallelState,
                                                 sharded_patch_attention)
    B, S, H, Dh = 8, 256, 16, 72
    q, k, v, kp, vp = (torch.randn((B, S, H, Dh), generator=gen, device="cuda")
                       for _ in range(5))
    fresh = torch.arange(B, device="cuda") % 3 == 0
    want_stale = _plain_displaced(q, k, v, kp, vp, P)
    want_fresh = ref.flash_attention_ref(q, k, v)
    T = S // P
    shards = [torch.stack([a, b], dim=2) for a, b in
              zip(k.split(T, 1), v.split(T, 1))]
    for p in range(P):
        rows = slice(p * T, (p + 1) * T)
        before = ops.LAUNCHES["flash_attention"]
        out, new = sharded_patch_attention(
            q[:, rows], k[:, rows], v[:, rows], PatchParallelState(kp, vp),
            mesh=_OnePatchGroup(p, P, shards), fresh=fresh)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["flash_attention"] == before + 1
        want = torch.where(fresh[:, None, None, None], want_fresh[:, rows],
                           want_stale[:, rows])
        _close(out, want, torch.float32)
        assert torch.equal(new.k_prev, k) and torch.equal(new.v_prev, v)


def test_placement_replicas_run_through_expert_ffn(gen):
    """A placed MoE layer on the card: the wire buffer and the replicas'
    local buffer each go through the expert_ffn kernel (two launches), and
    the output equals the unplaced layer's and the plain versions'."""
    from repro_torch.configs.dit_moe_xl import config
    from repro_torch.core import moe
    from repro_torch.core.placement import Placement, place_moe_params
    cfg = config().replace(num_shared_experts=0)
    d, E, f = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    kw = dict(generator=gen, device="cuda")
    p = {"router": torch.randn((d, E), **kw) / math.sqrt(d),
         "experts_gate": torch.randn((E, d, f), **kw) / math.sqrt(d),
         "experts_up": torch.randn((E, d, f), **kw) / math.sqrt(d),
         "experts_down": torch.randn((E, f, d), **kw) / math.sqrt(f),
         "router_bias": torch.zeros(E, device="cuda").index_fill_(0, torch.tensor(
             [5], device="cuda"), 1.5)}
    x = torch.randn((512, d), **kw)
    pl = Placement(perm=(3, 1, 0, 2, 5, 4, 7, 6), replicated=(5,), cap_scale=0.5)
    placed = place_moe_params(p, pl)
    before = ops.LAUNCHES["expert_ffn"]
    y_pl, aux_pl = moe.moe_forward(placed, x, cfg, placement=pl,
                                   capacity=pl.scaled_capacity(1024))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["expert_ffn"] == before + 2
    y, aux = moe.moe_forward(p, x, cfg, capacity=1024)
    _close(y_pl, y, torch.float32)
    assert torch.equal(aux_pl.served_counts, aux.served_counts)
    cpu = {k: t.cpu() for k, t in placed.items()}
    y_cpu, _ = moe.moe_forward(cpu, x.cpu(), cfg, placement=pl,
                               capacity=pl.scaled_capacity(1024))
    _close(y_pl.cpu(), y_cpu, torch.float32)
