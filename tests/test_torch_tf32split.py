"""The precision argument of the port's tensor-core kernels, on the CPU.

``csrc/flash_attention.cu`` and ``csrc/expert_ffn.cu`` run their f32
products as 3xTF32 (``csrc/tf32_mma.cuh``): x = big + small with
big = cvt.rna.tf32(x), small = cvt.rna.tf32(x - big), and a product sums
a_small*b_big + a_big*b_small + a_big*b_big in f32.  Here ``tf32_rna``
emulates cvt.rna.tf32.f32 on the f32 bit pattern (10 mantissa bits, ties
away from zero); tf32 x tf32 products are exact in f32, so an f32 matmul of
the parts is the tensor cores' arithmetic up to the order of the sums.  On
seeded inputs at the DiT-MoE-XL contraction lengths (d = 1152, f = 4608),
against float64: the split product meets the kernels' f32 tolerance
(rtol = atol = 1e-4, ``chip_smoke.py``'s TOL_F32) and one pass of plain
TF32 does not.

This file tests the arithmetic, not the port's code: the emulation here
stands in for the kernels.  The kernels themselves are held to the same
claim on the card by ``tests/test_torch_cuda.py``
(``test_one_tf32_pass_misses_the_f32_tolerance``: the committed sources
meet the tolerance, the same sources built with one TF32 pass miss it).
"""
import numpy as np
import pytest
import torch

TOL_F32 = dict(rtol=1e-4, atol=1e-4)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest tf32 value (as f32), ties away from zero: add half
    an ulp of the 10-bit mantissa to the magnitude bits, drop the low 13."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def mm_1xtf32(a, b):
    return tf32_rna(a) @ tf32_rna(b)


def mm_3xtf32(a, b):
    a_big, a_small = split(a)
    b_big, b_small = split(b)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def _bad(got: torch.Tensor, want: torch.Tensor) -> int:
    err = (got.double() - want).abs()
    return int((err > TOL_F32["atol"] + TOL_F32["rtol"] * want.abs()).sum())


@pytest.mark.parametrize("x,want", [
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),          # tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 3 * 2.0 ** -11, 1.0 + 2 * 2.0 ** -10),   # tie between odd and even
    (1.0 + 2.0 ** -12, 1.0),                       # below half an ulp
    (1.0 + 2.0 ** -11 + 2.0 ** -20, 1.0 + 2.0 ** -10),
    (2.0 - 2.0 ** -12, 2.0),                       # carries into the exponent
    (0.0, 0.0),
])
def test_tf32_rna_rounds_to_nearest_ties_away(x, want):
    got = tf32_rna(torch.tensor([x], dtype=torch.float32))
    assert got.item() == want


def test_split_parts_are_tf32_and_sum_close_to_x():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32) * 10.0)
    big, small = split(x)
    for part in (big, small):
        assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    # big + small keeps 22 of x's 24 significant bits
    rel = ((big.double() + small.double() - x.double()).abs() / x.double().abs())
    assert float(rel.max()) <= 2.0 ** -21


@pytest.mark.parametrize("K", [1152, 4608])
def test_3xtf32_product_meets_f32_tolerance_and_1xtf32_does_not(K):
    """x (64, K) @ w (K, 256) / sqrt(K), unit-scale outputs as in the
    expert FFN's gate/up (K = d) and down (K = f) products."""
    rng = np.random.default_rng(K)
    a = torch.from_numpy(rng.standard_normal((64, K)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((K, 256)) / np.sqrt(K)).astype(np.float32))
    want = a.double() @ b.double()
    assert _bad(mm_3xtf32(a, b), want) == 0
    assert _bad(mm_1xtf32(a, b), want) > 0
    err3 = float((mm_3xtf32(a, b).double() - want).abs().max())
    err1 = float((mm_1xtf32(a, b).double() - want).abs().max())
    assert err3 < err1 / 100


def test_3xtf32_gated_mlp_meets_f32_tolerance():
    """The expert FFN end to end at XL widths (d 1152, f 4608), each of its
    three products split: (silu(x Wg) * (x Wu)) Wd against float64."""
    rng = np.random.default_rng(7)
    d, f = 1152, 4608
    x = rng.standard_normal((32, d)).astype(np.float32)
    wg, wu = ((rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32)
              for _ in range(2))
    wd = (rng.standard_normal((f, d)) / np.sqrt(f)).astype(np.float32)
    tx, tg, tu, td = (torch.from_numpy(a) for a in (x, wg, wu, wd))
    g = mm_3xtf32(tx, tg)
    h = g * torch.sigmoid(g) * mm_3xtf32(tx, tu)
    got = mm_3xtf32(h, td)
    gd = tx.double() @ tg.double()
    want = (gd * torch.sigmoid(gd) * (tx.double() @ tu.double())) @ td.double()
    assert _bad(got, want) == 0


def test_3xtf32_attention_meets_f32_tolerance():
    """softmax(q k^T / sqrt(72)) v over 256 keys at the DiT head dim, with
    both products split and P in [0, 1] split like any f32 operand."""
    rng = np.random.default_rng(72)
    q, k, v = (torch.from_numpy(rng.standard_normal((256, 72)).astype(np.float32))
               for _ in range(3))
    s = mm_3xtf32(q / np.float32(np.sqrt(72.0)), k.T.contiguous())
    got = mm_3xtf32(torch.softmax(s, -1), v)
    want = torch.softmax(q.double() @ k.double().T / np.sqrt(72.0), -1) @ v.double()
    assert _bad(got, want) == 0
    assert _bad(mm_1xtf32(torch.softmax(s, -1), v), want) > 0
