"""The port's CUDA kernels on the card: each against its plain PyTorch
version, its launch counter, and the wrapper's input checks.

Every test here needs a CUDA device and is marked ``cuda``; without one it
skips.  This file imports neither JAX nor the JAX package, so it runs on a
machine with only PyTorch:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the shared conftest imports JAX.)  Tolerances: f32
1e-4 (sums of up to a few thousand terms in another order than cuBLAS'),
bf16 2e-2; the int8 codec's q and scale must agree exactly; the RWKV-6
recurrence 1e-3 (f32 state and output, sums of DK terms chained over T);
its backward as ``_close_scan_bwd`` says.
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


# the KV-cache masks: one query against a ring cache (wrapped, so k_pos is
# not monotone; gemma2's Dh 256 and a local window; empty slots before the
# ring fills), queries at an offset off the 128-row and key tiles, and the
# non-causal one-sided window of layers.attention
@pytest.mark.parametrize("case", ["ring wrapped", "ring filling", "offset chunk",
                                  "one-sided"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_with_cache_masks(gen, case, dtype):
    L = 300
    B, Sq, H, KVH, Dh = {"ring wrapped": (2, 1, 4, 2, 256),
                         "ring filling": (2, 1, 8, 1, 128),
                         "offset chunk": (1, 130, 4, 2, 64),
                         "one-sided": (1, 70, 4, 4, 72)}[case]
    kw = dict(generator=gen, device="cuda")
    q = torch.randn((B, Sq, H, Dh), **kw).to(dtype)
    k = torch.randn((B, L, KVH, Dh), **kw).to(dtype)
    v = torch.randn((B, L, KVH, Dh), **kw).to(dtype)
    slots = torch.arange(L, device="cuda")
    if case.startswith("ring"):
        pos = 1000 if case == "ring wrapped" else 137
        slot_pos = pos - torch.remainder(pos - slots, L)
        k_pos = torch.where(slot_pos >= 0, slot_pos, -1).int()
        opts = dict(causal=True, window=200 if Dh == 256 else None, softcap=50.0,
                    q_offset=pos, k_pos=k_pos, one_sided_window=True)
    elif case == "offset chunk":
        k_pos = torch.where(slots < 250, slots, -1).int()       # kv_valid_len 250
        opts = dict(causal=True, q_offset=117, k_pos=k_pos, one_sided_window=True)
    else:
        opts = dict(causal=False, window=40, one_sided_window=True)
    got = _launched("flash_attention", lambda: ops.flash_attention(q, k, v, **opts))
    _close(got, ref.flash_attention_ref(q, k, v, **opts), dtype)


# the hybrid, audio and VLM families' shapes (one batch row each): zamba2's
# shared block (Dh 112, causal, the prompt in a cache with room for decode),
# seamless's encoder (non-causal over 4,096 frames at Dh 64), the VLM's
# cross-attention (GQA 32 over 8, Dh 128, 1,601 image keys: not a multiple
# of the 16-key tile) for a prompt and one decode row.  bf16 is held with
# the atol in units of each query row's RMS, as chip_smoke.py's 3L rows: an
# output over thousands of keys is about 0.02 in size.
@pytest.mark.parametrize("case", ["zamba2 prefill", "seamless encoder",
                                  "vlm cross prompt", "vlm cross decode"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_at_the_family_shapes(gen, case, dtype):
    Sq, Sk, H, KVH, Dh, opts = {
        "zamba2 prefill": (1024, 1056, 32, 32, 112, dict(causal=True)),
        "seamless encoder": (4096, 4096, 16, 16, 64, dict(causal=False)),
        "vlm cross prompt": (512, 1601, 32, 8, 128, dict(causal=False)),
        "vlm cross decode": (1, 1601, 32, 8, 128, dict(causal=False))}[case]
    kw = dict(generator=gen, device="cuda")
    q = torch.randn((1, Sq, H, Dh), **kw).to(dtype)
    k = torch.randn((1, Sk, KVH, Dh), **kw).to(dtype)
    v = torch.randn((1, Sk, KVH, Dh), **kw).to(dtype)
    if case == "zamba2 prefill":
        idx = torch.arange(Sk, device="cuda", dtype=torch.int32)
        opts = dict(opts, k_pos=torch.where(idx < Sq, idx, -1))     # kv_valid_len Sq
    opts = dict(opts, one_sided_window=True)
    got = _launched("flash_attention", lambda: ops.flash_attention(q, k, v, **opts))
    want = ref.flash_attention_ref(q, k, v, **opts)
    assert tuple(got.shape) == (1, Sq, H, Dh)
    if dtype == torch.float32:
        _close(got, want, dtype)
    else:
        rms = want.float().pow(2).mean(-1, keepdim=True).sqrt()
        err = (got.float() - want.float()).abs()
        assert bool((err <= 2e-2 * rms + 2e-2 * want.float().abs()).all()), \
            float((err / rms).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_reads_unaligned_rows(gen, dtype):
    """Dh = 30 sliced one element into a 31-wide tensor: no row is 16-byte
    aligned, so q, k and v are loaded element by element."""
    base = torch.randn((2, 70, 3, 4, 31), generator=gen, device="cuda").to(dtype)
    q, k, v = base[..., 1:].unbind(2)
    assert q.stride(-1) == 1 and k.data_ptr() % 16 != 0
    got = _launched("flash_attention", lambda: ops.flash_attention(q, k, v, causal=True))
    _close(got, ref.flash_attention_ref(q, k, v, causal=True), dtype)


@pytest.mark.parametrize("kernel", ["expert_ffn", "flash_attention", "expert_ffn_bwd",
                                    "flash_attention_bwd"])
def test_one_tf32_pass_misses_the_f32_tolerance(gen, monkeypatch, kernel):
    """The 3xTF32 split is what holds the f32 kernels to 1e-4: the same
    sources built with -DDICE_TF32_ONE_PASS (one TF32 pass a product) miss
    it at the DiT-MoE-XL contraction lengths (d = 1152, f = 4608; Dh = 72).
    The backward kernels are held as chip_smoke.py holds them: dWg (a sum
    of C + d = 1,792 deep, XL refresh's) to compare_sum, the attention
    gradients to TOL_F32."""
    if kernel in ("expert_ffn_bwd", "flash_attention_bwd"):
        if kernel == "expert_ffn_bwd":
            x, wg, wu, wd = _expert_inputs(gen, 2, 640, 1152, 4608, torch.float32)
            dy = torch.randn((2, 640, 1152), generator=gen, device="cuda")
            args, pick = (x, wg, wu, wd, dy), 1
            run, plain = ops.expert_ffn_bwd, ref.expert_ffn_bwd_ref

            def close(g, w):
                _close_sum(g, w, 640 + 1152)
        else:
            q, k, v, do = (torch.randn((2, 128, 4, 72), generator=gen, device="cuda")
                           for _ in range(4))
            o, lse, _ = ops._flash_attention_fwd(q, k, v, want_lse=True)
            args, pick = (q, k, v, o, lse, do), 0
            run, plain = ops.flash_attention_bwd, ref.flash_attention_bwd_ref

            def close(g, w):
                _close(g, w, torch.float32)
        want = plain(*args)[pick]
        close(_launched(kernel, lambda: run(*args))[pick], want)
        one_pass = build.library(("DICE_TF32_ONE_PASS",))
        monkeypatch.setattr(ops, "library", lambda: one_pass)
        got = _launched(kernel, lambda: run(*args))[pick]
        with pytest.raises(AssertionError):
            close(got, want)
        return
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


def _close_scan_bwd(got, want, n):
    """As chip_smoke.compare_sum holds sums of ``n`` terms: rtol 1e-4 (f32)
    or 2e-2 (bf16 outputs, one rounding that can land on the neighbouring
    value), atol that plus max(1e-4, n 2^-24) of the largest magnitude
    (dlogw is a running sum over T: its error grows with T, not with each
    element's size)."""
    rtol = 1e-4 if got.dtype == torch.float32 else 2e-2
    atol = rtol + max(1e-4, n * 2.0 ** -24) * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


def _scan_bwd_inputs(gen, B, H, T, DK, dtype):
    """The forward's inputs with decays over [-6, 2] (w from 6e-4 to
    0.9975), dout and a final-state gradient."""
    r, k, v, _, u, s0 = _scan_inputs(gen, B, H, T, DK, dtype)
    kw = dict(generator=gen, device="cuda")
    logw = -torch.exp(torch.rand((B, H, T, DK), **kw) * 8.0 - 6.0)
    dout = torch.randn((B, H, T, DK), **kw)
    dS = 0.5 * torch.randn((B, H, DK, DK), **kw)
    return (r, k, v, logw, u, s0), dout, dS


@pytest.mark.parametrize("DK", [16, 32, 64, 128])
@pytest.mark.parametrize("T", [1, 37, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_dS", [True, False])
def test_rwkv6_scan_bwd_kernel(gen, DK, T, dtype, with_dS):
    args, dout, dS = _scan_bwd_inputs(gen, 2, 3, T, DK, dtype)
    dS_T = dS if with_dS else None
    got = _launched("rwkv6_scan_bwd", lambda: ops.rwkv6_scan_bwd(*args, dout, dS_T))
    want = ref.rwkv6_scan_bwd_ref(*args, dout, dS_T)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        _close_scan_bwd(g, w, T + DK)
    again = ops.rwkv6_scan_bwd(*args, dout, dS_T)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("case", ["logw -inf at one step", "logw over [-30, -20]"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_scan_bwd_kernel_at_extreme_decays(gen, case, dtype):
    """The chunked kernel's decays are products: w = 0 at one step of one
    row, and chunks whose decay products underflow f32, give the plain
    version's outputs, finite, bit for bit run to run.  Where they
    underflow, dlogw's values (w_t <= e^-20 times the rest) lie below the
    f32 rounding of the running sums of r dr and k dk it is the difference
    of: it is also held within 1e-5 of their largest term, as the CPU
    mirror holds it, which bounds its error, not its values."""
    args, dout, dS = _scan_bwd_inputs(gen, 2, 3, 100, 64, dtype)
    logw = args[3]
    if case.startswith("logw -inf"):
        logw[1, 2, 37, 5] = -math.inf
    else:
        logw.uniform_(-30.0, -20.0, generator=gen)
    got = _launched("rwkv6_scan_bwd", lambda: ops.rwkv6_scan_bwd(*args, dout, dS))
    want = ref.rwkv6_scan_bwd_ref(*args, dout, dS)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g.float()).all())
        _close_scan_bwd(g, w, 100 + 64)
    if case.startswith("logw over"):
        terms = max(float((args[0].float() * want[0].float()).abs().max()),
                    float((args[1].float() * want[1].float()).abs().max()))
        assert float((got[3] - want[3]).abs().max()) <= 1e-5 * terms
    again = ops.rwkv6_scan_bwd(*args, dout, dS)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_rwkv6_scan_bwd_reads_strided_inputs_and_keeps_nan(gen):
    """(B, T, H, DK) projections and output gradient permuted to
    (B, H, T, DK), as the model hands them over, give what contiguous
    copies give; a NaN in r gives NaN where the plain version has it."""
    B, T, H, DK = 2, 45, 3, 64
    kw = dict(generator=gen, device="cuda")
    r, k, v, dout = (torch.randn((B, T, H, DK), **kw).permute(0, 2, 1, 3) for _ in range(4))
    r, k, v = (a.to(torch.bfloat16) for a in (r, k, v))
    logw = (-torch.exp(torch.rand((B, T, H, DK), **kw) * 8.0 - 6.0)).permute(0, 2, 1, 3)
    u = (0.5 + 0.1 * torch.randn((H, DK), **kw)).to(torch.bfloat16)
    s0 = 0.1 * torch.randn((B, H, DK, DK), **kw)
    got = ops.rwkv6_scan_bwd(r, k, v, logw, u, s0, dout)
    flat = [a.contiguous() for a in (r, k, v, logw)]
    want = ops.rwkv6_scan_bwd(*flat, u, s0, dout.contiguous())
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    bad = flat[0].clone()
    bad[1, 2, 20, 5] = math.nan
    got = ops.rwkv6_scan_bwd(bad, *flat[1:], u, s0, dout.contiguous())
    want = ref.rwkv6_scan_bwd_ref(bad, *flat[1:], u, s0, dout.contiguous())
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
    assert bool(torch.isnan(got[3]).any())


def test_autograd_goes_through_the_scan_backward_kernel(gen):
    args, dout, dS = _scan_bwd_inputs(gen, 2, 3, 40, 64, torch.bfloat16)
    live = [a.clone().requires_grad_() for a in args]
    before = dict(ops.LAUNCHES)
    out, sT = ops.rwkv6_scan(*live)
    got = torch.autograd.grad((out * dout).sum(), live)
    want = ref.rwkv6_scan_bwd_ref(*args, dout)
    torch.cuda.synchronize()
    for g, w, x in zip(got, want, args):
        assert g.dtype == x.dtype
        _close_scan_bwd(g, w.to(x.dtype), 40 + 64)
    assert ops.LAUNCHES["rwkv6_scan"] == before["rwkv6_scan"] + 1
    assert ops.LAUNCHES["rwkv6_scan_bwd"] == before["rwkv6_scan_bwd"] + 1
    with torch.no_grad():
        plain_out, plain_sT = ops.rwkv6_scan(*args)
    assert torch.equal(plain_out, out.detach()) and torch.equal(plain_sT, sT.detach())


def test_rwkv6_scan_bwd_refuses_what_the_kernel_does_not_take(gen):
    args, dout, dS = _scan_bwd_inputs(gen, 1, 2, 8, 32, torch.float32)
    with pytest.raises(TypeError):
        ops.rwkv6_scan_bwd(*args, dout.to(torch.bfloat16))
    with pytest.raises(ValueError):
        ops.rwkv6_scan_bwd(*args, dout, dS.transpose(2, 3))
    with pytest.raises(ValueError):
        ops.rwkv6_scan_bwd(*args, dout.transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError):
        a = _scan_inputs(gen, 1, 2, 4, 24, torch.float32)
        ops.rwkv6_scan_bwd(*a, torch.zeros((1, 2, 4, 24), device="cuda"))


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


@pytest.mark.parametrize("e,d,f", [(6, 64, 96), (8, 1408, 5632)])
def test_paged_fetch_copies_each_shard_through_its_slot(gen, e, d, f):
    """Expert paging on the card: a pool of every rank's rows (pinned),
    fetched layer by layer through 2 slots by the copy thread's paced
    copies (a 3 x 32 MB leaf at G's width needs several pieces), gives the
    host rows bit for bit after the consumer's wait, phantom rows zero;
    a slot's next copy waits for its last reader."""
    from repro_torch.core.paging import PACE_BYTES, ExpertPool
    layers = {i: {"experts_gate": torch.randn((e, d, f), generator=gen,
                                              device="cuda").cpu(),
                  "experts_up": torch.randn((e, d, f), generator=gen,
                                            device="cuda").cpu(),
                  "experts_down": torch.randn((e, f, d), generator=gen,
                                              device="cuda").cpu()}
              for i in range(3)}
    pool = ExpertPool(layers, n_dev=4, device="cuda")
    pool.begin_run(1)
    assert pool.layer_shard_bytes(0) // 3 > PACE_BYTES or d < 1408
    for layer in (0, 1, 2, 0):
        for j in range(4):
            slot = pool.fetch(layer, j)
            got = slot.acquire()
            # a kernel that reads the slot before its release
            total = sum(v.sum() for v in got.values())
            slot.release()
            torch.cuda.synchronize()
            for k, v in pool.shard(layer, j).items():
                assert torch.equal(got[k].cpu(), v)
            assert bool(torch.isfinite(total))
    assert pool.transfers == 16 and pool.peak_resident_bytes == \
        2 * pool.layer_shard_bytes(0)


# ---------------------------------------------------------------------------
# training: the backward kernels and their autograd wiring
# ---------------------------------------------------------------------------
def _close_sum(got, want, n):
    """f32 sums of ``n`` products on the tensor cores: mma.sync's f32
    accumulation drifts from an f32 FMA loop the more the longer the sum,
    so the atol is TOL's plus max(1e-4, n 2^-24) of the largest value (as
    chip_smoke.py's ``compare_sum``)."""
    scale = float(want.abs().max())
    atol = 1e-4 + max(1e-4, n * 2.0 ** -24) * scale
    torch.testing.assert_close(got, want, rtol=1e-4, atol=atol)


@pytest.mark.parametrize("E,C,d,f", [(2, 16, 64, 128), (2, 136, 72, 100),
                                     (3, 129, 64, 768), (8, 640, 1152, 4608),
                                     (2, 40, 73, 97)])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_expert_ffn_bwd_kernel(gen, E, C, d, f, act):
    x, wg, wu, wd = _expert_inputs(gen, E, C, d, f, torch.float32)
    x[:, C // 2:] = 0.0                     # empty capacity rows
    dy = torch.randn((E, C, d), generator=gen, device="cuda")
    dy[:, C // 2:] = 0.0
    got = _launched("expert_ffn_bwd",
                    lambda: ops.expert_ffn_bwd(x, wg, wu, wd, dy, act=act))
    want = ref.expert_ffn_bwd_ref(x, wg, wu, wd, dy, act=act)
    for g, w, n in zip(got, want, (2 * f + d, C + d, C + d, C + d)):
        _close_sum(g, w, n)
    assert not bool(got[0][:, C // 2:].any())
    again = ops.expert_ffn_bwd(x, wg, wu, wd, dy, act=act)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_expert_ffn_bwd_reads_an_unaligned_base(gen):
    """A contiguous view one float into its storage: staged as an aligned
    copy for TMA, the gradients as for the tensor itself."""
    x, wg, wu, wd = _expert_inputs(gen, 2, 40, 64, 96, torch.float32)
    dy = torch.randn((2, 40, 64), generator=gen, device="cuda")
    store = torch.zeros(x.numel() + 1, device="cuda")
    store[1:] = x.reshape(-1)
    xv = store[1:].view(x.shape)
    assert xv.data_ptr() % 16 != 0
    got = _launched("expert_ffn_bwd", lambda: ops.expert_ffn_bwd(xv, wg, wu, wd, dy))
    want = ops.expert_ffn_bwd(x, wg, wu, wd, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_expert_ffn_bwd_without_rows_launches_nothing(gen):
    """C = 0: zero weight gradients and an empty dX, no launch (TMA's
    tensor maps take no empty dim)."""
    x, wg, wu, wd = _expert_inputs(gen, 2, 0, 64, 96, torch.float32)
    dy = torch.zeros((2, 0, 64), device="cuda")
    before = ops.LAUNCHES["expert_ffn_bwd"]
    dx, dwg, dwu, dwd = ops.expert_ffn_bwd(x, wg, wu, wd, dy)
    assert ops.LAUNCHES["expert_ffn_bwd"] == before
    assert dx.shape == (2, 0, 64)
    assert not (dwg.any() or dwu.any() or dwd.any())


@pytest.mark.parametrize("B,Sq,Sk,H,Dh", [(2, 64, 64, 4, 24), (2, 65, 257, 4, 72),
                                          (1, 40, 70, 2, 128), (4, 256, 256, 16, 88)])
def test_flash_attention_bwd_kernel(gen, B, Sq, Sk, H, Dh):
    q = torch.randn((B, Sq, H, Dh), generator=gen, device="cuda")
    k, v = (torch.randn((B, Sk, H, Dh), generator=gen, device="cuda") for _ in range(2))
    do = torch.randn((B, Sq, H, Dh), generator=gen, device="cuda")
    o0 = ops.flash_attention(q, k, v)
    o, lse, o32 = ops._flash_attention_fwd(q, k, v, want_lse=True)
    assert torch.equal(o, o0) and o32 is o  # the lse store changes nothing
    _close(lse, ref.attention_lse_ref(q, k), torch.float32)
    got = _launched("flash_attention_bwd",
                    lambda: ops.flash_attention_bwd(q, k, v, o, lse, do))
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do)
    for g, w in zip(got, want):
        _close(g, w, torch.float32)
    again = ops.flash_attention_bwd(q, k, v, o, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _grad_close(got, want, dtype):
    """f32: TOL; bf16: the kernel and the plain version round the same f32
    value once, which can land on the neighbouring bf16 value (2^-7
    relative), over f32 sums taken in another order (1e-3 of the
    tensor's largest value)."""
    if dtype == torch.float32:
        _close(got, want, dtype)
        return
    g, w = got.float(), want.float()
    assert bool(((g - w).abs() <= 8e-3 * w.abs() + 1e-3 * w.abs().max()).all())


# the LM families' training shapes, cut: causal GQA at Dh 128, Dh 112 (NT
# 16 with a ragged last Dh tile), GQA 4 over 1, cross-attention over
# 1,601 keys (off the 32-key tile), Sq != Sk off the 64-row tile, 5 rows
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,Dh,causal", [
    (2, 128, 128, 8, 2, 128, True), (2, 70, 70, 4, 4, 112, True),
    (1, 200, 200, 4, 1, 64, True), (2, 33, 1601, 4, 2, 128, False),
    (2, 128, 300, 4, 4, 64, False), (1, 5, 5, 2, 1, 32, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel_at_lm_shapes(gen, B, Sq, Sk, H, KVH, Dh, causal, dtype):
    q = torch.randn((B, Sq, H, Dh), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((B, Sk, KVH, Dh), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    do = torch.randn((B, Sq, H, Dh), generator=gen, device="cuda").to(dtype)
    o, lse, o32 = ops._flash_attention_fwd(q, k, v, causal=causal, want_lse=True)
    want_o32, want_lse = ref.flash_attention_ref(q, k, v, causal=causal, stats=True)
    _close(lse, want_lse, torch.float32)
    _close(o32, want_o32, torch.float32)
    assert o32.dtype == torch.float32 and torch.equal(o, o32.to(dtype))
    ops.reset_launches()
    got = _launched("flash_attention_bwd", lambda: ops.flash_attention_bwd(
        q, k, v, o32, lse, do, causal=causal))
    assert ops.FLASH_BWD_SHAPES == {(B, Sq, Sk, H, KVH, Dh, causal, None, None): 1}
    want = ref.flash_attention_bwd_ref(q, k, v, o32, lse, do, causal=causal)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape
        _grad_close(g, w, dtype)
    again = ops.flash_attention_bwd(q, k, v, o32, lse, do, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_autograd_goes_through_the_backward_kernels(gen):
    x, wg, wu, wd = (t.requires_grad_() for t in
                     _expert_inputs(gen, 2, 40, 64, 96, torch.float32))
    before = dict(ops.LAUNCHES)
    y = ops.expert_ffn(x, wg, wu, wd)
    dy = torch.randn_like(y)
    got = torch.autograd.grad(y, [x, wg, wu, wd], dy)
    want = ref.expert_ffn_bwd_ref(x.detach(), wg.detach(), wu.detach(), wd.detach(), dy)
    for g, w in zip(got, want):
        _close_sum(g, w, 2 * 96 + 64)
    q, k, v = (torch.randn((2, 64, 4, 72), generator=gen, device="cuda").requires_grad_()
               for _ in range(3))
    o = ops.flash_attention(q, k, v)
    do = torch.randn_like(o)
    got = torch.autograd.grad(o, [q, k, v], do)
    want = ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), o.detach(),
                                       ref.attention_lse_ref(q.detach(), k.detach()), do)
    for g, w in zip(got, want):
        _close(g, w, torch.float32)
    torch.cuda.synchronize()
    for name in ("expert_ffn", "flash_attention", "expert_ffn_bwd", "flash_attention_bwd"):
        assert ops.LAUNCHES[name] == before[name] + 1, name
    with pytest.raises(NotImplementedError):       # the Pallas kernel's symmetric window
        o = ops.flash_attention(q, k, v, window=16)
        o.sum().backward()
    with pytest.raises(NotImplementedError):       # ring-cache key positions
        o = ops.flash_attention(q, k, v, causal=True, q_offset=3,
                                k_pos=torch.arange(64, dtype=torch.int32, device="cuda"))
        o.sum().backward()


# gemma2's and stablelm's training: a one-sided window (causal or not),
# the logit softcap, Dh 160 (NT 20) and 256 (NT 32; f32 on 16-row tiles),
# Dh 200 (a ragged last tile in the second column half), windows that
# skip key and query tiles and one of 0 (every pair dropped but the
# non-causal keys past the query)
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,Dh,causal,window,softcap", [
    (2, 128, 128, 4, 2, 256, True, 48, 50.0), (2, 96, 96, 8, 2, 160, True, None, None),
    (1, 200, 200, 4, 2, 256, True, 64, 30.0), (2, 70, 90, 4, 2, 160, False, 20, 5.0),
    (1, 130, 130, 2, 1, 200, True, 40, None), (1, 64, 80, 2, 2, 32, False, 0, 2.0),
    (2, 128, 128, 4, 4, 64, True, None, 3.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel_with_window_softcap_and_wide_heads(
        gen, B, Sq, Sk, H, KVH, Dh, causal, window, softcap, dtype):
    q = torch.randn((B, Sq, H, Dh), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((B, Sk, KVH, Dh), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    do = torch.randn((B, Sq, H, Dh), generator=gen, device="cuda").to(dtype)
    opts = dict(causal=causal, window=window, softcap=softcap)
    o, lse, o32 = ops._flash_attention_fwd(q, k, v, one_sided_window=True, want_lse=True,
                                           **opts)
    want_o32, want_lse = ref.flash_attention_ref(q, k, v, one_sided_window=True, stats=True,
                                                 **opts)
    _close(lse, want_lse, torch.float32)
    _close(o32, want_o32, torch.float32)
    ops.reset_launches()
    got = _launched("flash_attention_bwd",
                    lambda: ops.flash_attention_bwd(q, k, v, o32, lse, do, **opts))
    assert ops.FLASH_BWD_SHAPES == {(B, Sq, Sk, H, KVH, Dh, causal, window, softcap): 1}
    want = ref.flash_attention_bwd_ref(q, k, v, o32, lse, do, **opts)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape
        _grad_close(g, w, dtype)
    again = ops.flash_attention_bwd(q, k, v, o32, lse, do, **opts)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_autograd_goes_through_the_flash_backward_with_gemma2_s_masks(gen):
    """``layers.attention`` under grad: a local layer's window and the
    softcap at Dh 256, bf16, both flash kernels, the plain gradients."""
    from repro_torch.models import layers
    q, k, v = (torch.randn((1, 96, 4, 256), generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    k, v = k[:, :, :2].contiguous(), v[:, :, :2].contiguous()
    live = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.reset_launches()
    o = layers.attention(*live, causal=True, window=40, softcap=50.0)
    do = torch.randn(o.shape, generator=gen, device="cuda").bfloat16()
    got = torch.autograd.grad(o, live, do)
    o32, lse = ref.flash_attention_ref(q, k, v, causal=True, window=40, softcap=50.0,
                                       one_sided_window=True, stats=True)
    want = ref.flash_attention_bwd_ref(q, k, v, o32, lse, do, causal=True, window=40,
                                       softcap=50.0)
    for g, w in zip(got, want):
        _grad_close(g, w, torch.bfloat16)
    assert ops.FLASH_SHAPES == {(1, 96, 96, 4, 2, 256, True, 40, 50.0): 1}
    assert ops.FLASH_BWD_SHAPES == {(1, 96, 96, 4, 2, 256, True, 40, 50.0): 1}


def _close_bf16_sum(got, want32, n):
    """A bf16 gradient against the plain version's f32 sum of ``n``
    products: one rounding (half a bf16 ulp, 2^-8 relative) of a sum that
    drifts as ``_close_sum`` allows."""
    g, w = got.float(), want32
    atol = 1e-4 + max(1e-4, n * 2.0 ** -24) * float(w.abs().max())
    assert bool(((g - w).abs() <= 2.0 ** -8 * w.abs() + atol).all()), \
        float((g - w).abs().max())


# the MoE family's bf16 training: qwen3-moe's experts cut (128 experts of
# f 768 over d 2048, here 8 of 96 over 256), d and f off the 16-byte
# rows (staged), C off the 4-row scratch stride, the smoke configs' 4 x 64
@pytest.mark.parametrize("E,C,d,f", [(8, 80, 256, 96), (2, 40, 73, 97), (3, 129, 64, 768),
                                     (4, 18, 128, 64)])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_expert_ffn_bwd_kernel_bf16(gen, E, C, d, f, act):
    x, wg, wu, wd = _expert_inputs(gen, E, C, d, f, torch.bfloat16)
    x[:, C // 2:] = 0.0                     # empty capacity rows
    dy = torch.randn((E, C, d), generator=gen, device="cuda").bfloat16()
    dy[:, C // 2:] = 0.0
    ops.reset_launches()
    got = _launched("expert_ffn_bwd",
                    lambda: ops.expert_ffn_bwd(x, wg, wu, wd, dy, act=act))
    assert ops.FFN_BWD_SHAPES == {(E, C, d, f, "bfloat16"): 1}
    want = ref.expert_ffn_bwd_ref(*(t.float() for t in (x, wg, wu, wd, dy)), act=act)
    for g, w, x_, n in zip(got, want, (x, wg, wu, wd), (2 * f + d, C + d, C + d, C + d)):
        assert g.dtype == torch.bfloat16 and g.shape == x_.shape
        _close_bf16_sum(g, w, n)
    assert not bool(got[0][:, C // 2:].any())
    again = ops.expert_ffn_bwd(x, wg, wu, wd, dy, act=act)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_autograd_goes_through_the_bf16_expert_backward(gen):
    x, wg, wu, wd = (t.requires_grad_() for t in
                     _expert_inputs(gen, 4, 40, 128, 96, torch.bfloat16))
    before = dict(ops.LAUNCHES)
    y = ops.expert_ffn(x, wg, wu, wd, act="gelu")
    dy = torch.randn(y.shape, generator=gen, device="cuda").bfloat16()
    got = torch.autograd.grad(y, [x, wg, wu, wd], dy)
    want = ref.expert_ffn_bwd_ref(*(t.detach().float() for t in (x, wg, wu, wd)),
                                  dy.float(), act="gelu")
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _close_bf16_sum(g, w, 2 * 96 + 128)
    torch.cuda.synchronize()
    for name in ("expert_ffn", "expert_ffn_bwd"):
        assert ops.LAUNCHES[name] == before[name] + 1, name
