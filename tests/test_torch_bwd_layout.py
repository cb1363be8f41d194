"""The expert FFN backward kernel's layout and arithmetic, on the CPU.

``csrc/expert_ffn_bwd.cu`` runs on TMA and wgmma, which want every row
stride a multiple of 16 bytes, so the wrapper (``kernels/ops.py``) decides
in Python the widths the kernel runs at: d and f padded to multiples of 4
(with zero-padded copies of the operands when they are not), the
scratch's capacity stride padded likewise, and the scratch held
transposed, (3, E, f, c).  These tests hold those decisions at the shapes
``chip_smoke.py`` phase 3B and the card tests use, and show that the
zero padding leaves every gradient inside (d, f) as it is.

They also hold the 3xTF32 split both backward kernels use
(``csrc/tf32_mma.cuh`` ``FastFrag``), emulated on the f32 bit pattern as
``tests/test_torch_tf32split.py`` emulates ``cvt.rna``: the big part is
cvt.rna's (half a tf32 ulp added, the low 13 bits cleared), the small part
x - big with its low 13 bits cleared.  The kernels rely on no rounding of
the hardware's: both parts are exact tf32 values.  At the expert FFN
backward's sum lengths, C + d = 1,792 for the weight gradients and 2f + d =
10,368 for dX at DiT-MoE-XL refresh shapes, against float64 with
``chip_smoke.py``'s ``compare_sum`` tolerance for those lengths, the split
meets it for both, and one TF32 pass misses it for the weight gradients.
For dX that tolerance, which grows with the sum's length, is loose enough
to pass one pass too: there the split is held to being a hundred times
closer to float64 instead.  The attention backward's five products
through the split meet TOL_F32 per element at the DiT's head dim.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from test_torch_tf32split import mm_1xtf32, tf32_rna

TOL_F32 = dict(rtol=1e-4, atol=1e-4)


def split_fast(x: torch.Tensor):
    """The backward kernels' split (FastFrag) on the f32 bit pattern: big =
    the bits plus half a tf32 ulp with the low 13 cleared (int32 arithmetic
    wraps as the card's does), small = x - big with the low 13 bits
    cleared."""
    big = ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    small = ((x - big).contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)
    return big, small


def mm_fast3(a, b):
    a_big, a_small = split_fast(a)
    b_big, b_small = split_fast(b)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big

# (E, C, d, f) of chip_smoke.py phase 3B and tests/test_torch_cuda.py
SHAPES = {
    (8, 640, 1152, 4608): (1152, 4608, 640, False),    # XL refresh
    (8, 320, 1408, 5632): (1408, 5632, 320, False),    # DiT-MoE-G, an ep=2 rank
    (3, 129, 1152, 4608): (1152, 4608, 132, False),    # C off the tiles
    (2, 136, 72, 100): (72, 100, 136, False),          # ragged d and f
    (2, 40, 73, 97): (76, 100, 40, True),              # odd d and f
    (2, 16, 64, 128): (64, 128, 16, False),
    (3, 129, 64, 768): (64, 768, 132, False),
    (2, 40, 64, 96): (64, 96, 40, False),              # the NaN-row case
}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_layout_pads_widths_and_scratch_stride_to_16_bytes(shape):
    E, C, d, f = shape
    lay = ops.ffn_bwd_layout(E, C, d, f)
    assert (lay.d, lay.f, lay.c, lay.staged) == SHAPES[shape]
    assert lay.scratch == (3, E, lay.f, lay.c)
    for n in (lay.d, lay.f, lay.c):
        assert n % 4 == 0                  # 16-byte rows of f32
    # transient memory stays 3 x E x C x f f32, but for the padding
    assert 3 * E * lay.f * lay.c - 3 * E * C * f <= 3 * E * (3 * lay.f + 3 * C)


def _inputs(E, C, d, f, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, d)).astype(np.float32)
    x[:, C - C // 4:] = 0.0                # empty capacity rows
    dy = rng.standard_normal((E, C, d)).astype(np.float32)
    dy[:, C - C // 4:] = 0.0
    wg, wu = ((rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(np.float32)
              for _ in range(2))
    wd = (rng.standard_normal((E, f, d)) / np.sqrt(f)).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (x, wg, wu, wd, dy))


@pytest.mark.parametrize("shape", [(2, 40, 73, 97), (1, 9, 5, 3), (2, 12, 6, 10)])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_zero_padded_copies_leave_the_gradients_as_they_are(shape, act):
    """The staged path: the plain backward on the zero-padded copies, cut
    back to (d, f), equals the plain backward on the inputs."""
    E, C, d, f = shape
    args = _inputs(E, C, d, f, seed=sum(shape))
    lay = ops.ffn_bwd_layout(E, C, d, f)
    assert lay.staged
    staged = ops.stage_ffn_bwd_inputs(lay, *args)
    assert [tuple(t.shape) for t in staged] == [
        (E, C, lay.d), (E, lay.d, lay.f), (E, lay.d, lay.f), (E, lay.f, lay.d),
        (E, C, lay.d)]
    for t, s in zip(args, staged):       # the inputs in the copies' corner, zeros around
        corner = tuple(slice(0, n) for n in t.shape)
        assert torch.equal(s[corner], t)
        rest = s.clone()
        rest[corner] = 0.0
        assert not bool(rest.any())
    got = ops.unstage_ffn_bwd_grads(lay, d, f, ref.expert_ffn_bwd_ref(*staged, act=act))
    want = ref.expert_ffn_bwd_ref(*args, act=act)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_contiguous()
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    assert not bool(got[0][:, C - C // 4:].any())


def test_aligned_widths_and_bases_pass_the_inputs_through():
    args = _inputs(2, 16, 64, 128, seed=3)
    lay = ops.ffn_bwd_layout(2, 16, 64, 128)
    assert not lay.staged
    staged = ops.stage_ffn_bwd_inputs(lay, *args)
    assert all(s is t for s, t in zip(staged, args))
    grads = tuple(torch.zeros(1) for _ in range(4))
    assert all(a is b for a, b in zip(ops.unstage_ffn_bwd_grads(lay, 64, 128, grads), grads))


def test_an_unaligned_view_is_copied_and_the_others_pass_through():
    """TMA reads from 16-byte aligned addresses: a contiguous view that
    starts one float into its storage is staged as a copy."""
    args = list(_inputs(2, 16, 64, 128, seed=4))
    store = torch.zeros(args[0].numel() + 1)
    store[1:] = args[0].reshape(-1)
    args[0] = store[1:].view(args[0].shape)
    assert args[0].is_contiguous() and args[0].data_ptr() % 16 != 0
    staged = ops.stage_ffn_bwd_inputs(ops.ffn_bwd_layout(2, 16, 64, 128), *args)
    assert staged[0] is not args[0] and staged[0].data_ptr() % 16 == 0
    assert torch.equal(staged[0], args[0])
    assert all(s is t for s, t in zip(staged[1:], args[1:]))


def test_no_rows_give_zero_gradients_on_the_cpu():
    """C = 0: every gradient is zero (the card's wrapper launches nothing)."""
    x = torch.zeros((2, 0, 8))
    wg, wu = torch.randn((2, 8, 12)), torch.randn((2, 8, 12))
    wd = torch.randn((2, 12, 8))
    dx, dwg, dwu, dwd = ops.expert_ffn_bwd(x, wg, wu, wd, torch.zeros((2, 0, 8)))
    assert dx.shape == (2, 0, 8)
    for g, w in ((dwg, wg), (dwu, wu), (dwd, wd)):
        assert g.shape == w.shape and not bool(g.any())


def _sum_tol_bad(got, want, n):
    """Elements outside chip_smoke.py's compare_sum tolerance for sums of n
    products, and the largest error over that tolerance."""
    atol = TOL_F32["atol"] + max(TOL_F32["rtol"], n * 2.0 ** -24) * float(want.abs().max())
    err = (got.double() - want).abs()
    lim = atol + TOL_F32["rtol"] * want.abs()
    return int((err > lim).sum()), float((err / lim).max())


def _backward(mm, x, dy, wg, wu, wd):
    """dH, dG, dU as the kernel forms them (silu), each product through mm;
    returns (dG, dU)."""
    g, u = mm(x, wg), mm(x, wu)
    dh = mm(dy, wd.T.contiguous())
    s = torch.sigmoid(g)
    return dh * u * (s * (1 + g * (1 - s))), dh * (g * s)


def _xl_operands():
    rng = np.random.default_rng(1792)
    C, d, f = 640, 1152, 4608
    x, dy = (torch.from_numpy(rng.standard_normal((C, d)).astype(np.float32))
             for _ in range(2))
    wg, wu = (torch.from_numpy((rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32))
              for _ in range(2))
    wd = torch.from_numpy((rng.standard_normal((f, d)) / np.sqrt(f)).astype(np.float32))
    return x, dy, wg, wu, wd


def _mm64(a, b):
    return a.double() @ b.double()


def test_split_meets_the_weight_gradient_tolerance_and_one_pass_does_not():
    """dWg = X^T dG at XL refresh (C = 640 rows of d = 1152): sums C + d =
    1,792 deep, for 64 columns of f (each column is its own chain)."""
    x, dy, wg, wu, wd = _xl_operands()
    cols = slice(0, 64)
    args = (x, dy, wg[:, cols], wu[:, cols], wd[cols])
    xt = x.T.contiguous()
    want = _mm64(xt, _backward(_mm64, *args)[0])
    split = mm_fast3(xt, _backward(mm_fast3, *args)[0])
    one = mm_1xtf32(xt, _backward(mm_1xtf32, *args)[0])
    n = 640 + 1152
    assert _sum_tol_bad(split, want, n)[0] == 0
    assert _sum_tol_bad(one, want, n)[0] > 0


def test_split_meets_the_dx_tolerance_a_hundred_times_closer_than_one_pass():
    """dX = dG Wg^T + dU Wu^T at XL refresh for 16 capacity rows: sums
    2f + d = 10,368 deep."""
    x, dy, wg, wu, wd = _xl_operands()
    rows = slice(0, 16)
    args = (x[rows], dy[rows], wg, wu, wd)
    wgt, wut = wg.T.contiguous(), wu.T.contiguous()

    def dx(mm):
        dg, du = _backward(mm, *args)
        return mm(dg, wgt) + mm(du, wut)

    want = dx(_mm64)
    n = 2 * 4608 + 1152
    bad, worst_split = _sum_tol_bad(dx(mm_fast3), want, n)
    assert bad == 0
    worst_one = _sum_tol_bad(dx(mm_1xtf32), want, n)[1]
    assert worst_split < worst_one / 100


# ---------------------------------------------------------------------------
# the split itself, and the attention backward's products through it
# ---------------------------------------------------------------------------
def test_fast_split_big_is_cvt_rna_and_small_is_close():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(4096) * 10.0, rng.standard_normal(64) * 1e-30,
        [0.0, -0.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 2.0 - 2.0 ** -12, 3e38]
    ]).astype(np.float32))
    big, small = split_fast(x)
    assert torch.equal(big, tf32_rna(x))            # cvt.rna.tf32.f32's big part
    for part in (big, small):
        assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    finite = torch.isfinite(big)
    rel = ((big.double() + small.double() - x.double()).abs()[finite]
           / x.double().abs()[finite].clamp_min(1e-300))
    assert float(rel.max()) <= 2.0 ** -21


def test_fast_split_keeps_nan_and_inf_in_the_products():
    """The card's NaN (0x7FFFFFFF, what its arithmetic makes), a quiet NaN
    and infinities: every product of such an operand is NaN or infinite,
    as with the cvt split."""
    bits = torch.tensor([0x7FFFFFFF, 0x7FC00000, 0xFFC00000 - 2 ** 32, 0x7F800000,
                         0xFF800000 - 2 ** 32], dtype=torch.int32)
    x = bits.view(torch.float32)
    big, small = split_fast(x)
    assert bool(torch.isnan(small).all())
    a = x[:, None].expand(5, 8).contiguous()
    b = torch.ones((8, 3))
    assert not bool(torch.isfinite(mm_fast3(a, b)).any())


def _attention_bwd(mm, q, k, v, do):
    """The flash backward's five products for one head, each through mm."""
    scale = np.float32(1.0 / np.sqrt(q.shape[-1]))
    s = mm(q * scale, k.T.contiguous())
    lse = torch.logsumexp(s.double(), -1).to(s.dtype)[:, None]
    p = torch.exp(s - lse)
    o = mm(p, v)
    dd = (do * o).sum(-1, keepdim=True)
    ds = p * (mm(do, v.T.contiguous()) - dd)
    return (mm(ds, k) * scale, mm(ds.T.contiguous(), q) * scale,
            mm(p.T.contiguous(), do))


def test_fast_split_attention_backward_meets_f32_tolerance():
    """dQ, dK, dV of one DiT-MoE-XL head (256 tokens, Dh 72) with every
    product split the fast way, against float64: within TOL_F32 per
    element, as chip_smoke.py holds the kernel; one TF32 pass is not."""
    rng = np.random.default_rng(72)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((256, 72)).astype(np.float32))
                   for _ in range(4))
    want = _attention_bwd(_mm64, q.double(), k.double(), v.double(), do.double())
    got = _attention_bwd(mm_fast3, q, k, v, do)
    one = _attention_bwd(mm_1xtf32, q, k, v, do)
    bad = lambda g, w: int(((g.double() - w).abs()                    # noqa: E731
                            > TOL_F32["atol"] + TOL_F32["rtol"] * w.abs()).sum())
    assert all(bad(g, w) == 0 for g, w in zip(got, want))
    assert any(bad(g, w) > 0 for g, w in zip(one, want))
