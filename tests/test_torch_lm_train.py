"""The port's training of the dense, hybrid, audio and VLM families against
the JAX package, on the CPU.

The flash backward's plain version (``kernels/ref.flash_attention_bwd_ref``,
what ``csrc/flash_attention_bwd.cu`` computes) is held against ``jax.vjp``
of the reference's ``layers.attention``: causal, GQA, bf16, cross-attention
with Sq != Sk, Dh 112, and a non-causal case past 2^22 scores, where the
reference takes its blocked online-softmax path.  Then, at the smoke
configs of qwen3-32b, deepseek-67b, zamba2-7b, seamless-m4t-large-v2 and
llama-3.2-vision-11b, with the reference's params carried over by
``bridge.from_jax_params`` (the VLM's cross gates drawn off their zero
init, which would cut the cross path out of every gradient), tokens from
``token_batches`` and the stub audio frames and image embeddings drawn
with numpy in bf16: the step-0 gradients of ``loss_fn`` against
``jax.grad`` of the reference's, leaf by leaf; ``lm_train_step`` against
the reference's jitted step (``launch/train.py``'s value_and_grad, clip and
AdamW) fed the same batches; the recompute (``remat``) against none, bit
for bit; and the CLI on every LM family's smoke config (gemma2-9b,
stablelm-12b and the MoE family's gradients: ``test_torch_gemma2_train.py``
and ``test_torch_moe_train.py``).

Tolerances, with their reasons:
  * the plain backward against ``jax.vjp``: f32 within ``1e-5 *
    max|want|`` (f32 sums in another order; the reference scales the
    logits' cotangent before its products, the plain version after);
    bf16 within one bf16 ulp, ``2^-7 |want|``, plus ``1e-5 * max|want|``
    (both compute in f32 and round once; the f32 sums' order can move a
    value across a rounding boundary).  The plain version's D is the dot
    product of dO with the unrounded f32 output, as the reference's sum
    of P dP is: with the bf16 output 19% of bf16 dq and dk elements land
    elsewhere, up to half of their own size;
  * step-0 gradients (``GRAD_TOL``): f32 params within ``1e-4 *
    max|want| + 1e-6`` per leaf; bf16 params within ``5e-2 * max|want|``,
    ``MODEL_TOL``'s bf16 rtol (the two frameworks' bf16 matrix products
    round a few outputs to the neighbouring value, as for RWKV-6);
  * the training losses (``LOSS_RTOL``): f32 1e-5, bf16 5e-3 over
    ``TRAIN_STEPS`` steps (the bf16 forward alone puts step 0 about 1e-3
    apart; the bf16 updates then round apart at a few elements).
"""
import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.models import layers as jax_layers
from repro.models.api import get_model as jax_get_model
from repro.optim import adamw as jax_adamw
from repro_torch import bridge
from repro_torch.checkpoint.io import flatten
from repro_torch.configs import get_config, get_smoke
from repro_torch.data.synthetic import token_batches
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as train_cli
from repro_torch.launch.train import lm_train_step
from repro_torch.models.api import get_model
from repro_torch.optim import adamw

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
NAMES = ("qwen3-32b", "deepseek-67b", "zamba2-7b", "seamless-m4t-large-v2",
         "llama-3.2-vision-11b")
F32_REL = 1e-5
BF16_ULP = 2.0 ** -7
GRAD_TOL = {"float32": (1e-4, 1e-6), "bfloat16": (5e-2, 0.0)}
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 5e-3}
BATCH, SEQ, TRAIN_STEPS = 2, 32, 4


def _np(x):
    return (x.to(torch.float32).numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _to_torch(a):
    """A jax array as a torch tensor of the same dtype (bf16 by its bits)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


# ---------------------------------------------------------------------------
# (1) the plain flash backward against jax.vjp of layers.attention
# ---------------------------------------------------------------------------
ATTN_CASES = {
    "causal": (2, 40, 40, 4, 4, 32, True),
    "causal GQA 8 over 2": (2, 40, 40, 8, 2, 32, True),
    "cross GQA, Sq != Sk, 37 keys": (2, 24, 37, 4, 2, 16, False),
    "causal Dh 112": (1, 33, 33, 2, 2, 112, True),
    "causal GQA 4 over 1, Dh 128": (1, 20, 20, 4, 1, 128, True),
}


def _attn_inputs(seed, B, Sq, Sk, H, KVH, Dh, dtype):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, Sq, H, Dh), (B, Sk, KVH, Dh), (B, Sk, KVH, Dh), (B, Sq, H, Dh))]
    jdt = DTYPES[dtype][0]
    jax_in = [jnp.asarray(a).astype(jdt) for a in arrays]
    return jax_in, [_to_torch(a) for a in jax_in]


def _check_attention_grads(got, want, dtype):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, name
        top = np.abs(w).max()
        if dtype == "float32":
            bound = F32_REL * top
        else:
            bound = BF16_ULP * np.abs(w) + F32_REL * top
        assert (np.abs(g - w) <= bound).all(), (name, np.abs(g - w).max(), top)


@pytest.mark.parametrize("case", list(ATTN_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_ref_matches_jax_vjp_of_layers_attention(case, dtype):
    B, Sq, Sk, H, KVH, Dh, causal = ATTN_CASES[case]
    (jq, jk, jv, jdo), (q, k, v, do) = _attn_inputs(len(case), B, Sq, Sk, H, KVH, Dh, dtype)
    out, vjp = jax.vjp(partial(jax_layers.attention, causal=causal), jq, jk, jv)
    want = vjp(jdo)
    o32, lse = ref.flash_attention_ref(q, k, v, causal=causal, stats=True)
    np.testing.assert_allclose(_np(o32.to(q.dtype)), _np(out), rtol=1e-5 if
                               dtype == "float32" else BF16_ULP, atol=1e-6)
    got = ref.flash_attention_bwd_ref(q, k, v, o32, lse, do, causal=causal)
    for g, x in zip(got, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
    _check_attention_grads(got, want, dtype)
    # query chunks give the same gradients (dk, dv summed over the chunks)
    chunked = ref.flash_attention_bwd_ref(q, k, v, o32, lse, do, causal=causal, rows=7)
    _check_attention_grads(chunked, want, dtype)


def test_flash_attention_bwd_ref_matches_the_blocked_reference():
    """Sq * Sk = 2050^2 > 2^22: the reference's ``layers.attention`` takes
    ``_blocked_attention`` (online softmax over 2,048-key blocks, the
    second one padded), as the seamless encoder does at full size."""
    B, S, H, Dh = 1, 2050, 2, 16
    assert S * S > jax_layers._DENSE_SCORE_LIMIT
    (jq, jk, jv, jdo), (q, k, v, do) = _attn_inputs(9, B, S, S, H, H, Dh, "float32")
    _, vjp = jax.vjp(jax_layers.attention, jq, jk, jv)
    o32, lse = ref.flash_attention_ref(q, k, v, stats=True)
    _check_attention_grads(ref.flash_attention_bwd_ref(q, k, v, o32, lse, do),
                           vjp(jdo), "float32")


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_plain_attention_stats_over_query_chunks(case):
    """``flash_attention_ref`` over query chunks (each at its own query
    offset) gives the whole call's output, and with ``stats`` its f32
    output and log-sum-exp, whose rounding is the plain output and whose
    log-sum-exp is ``attention_lse_ref``'s."""
    B, Sq, Sk, H, KVH, Dh, causal = ATTN_CASES[case]
    _, (q, k, v, _) = _attn_inputs(11, B, Sq, Sk, H, KVH, Dh, "bfloat16")
    o32, lse = ref.flash_attention_ref(q, k, v, causal=causal, stats=True)
    plain = ref.flash_attention_ref(q, k, v, causal=causal)
    assert o32.dtype == lse.dtype == torch.float32 and lse.shape == (B, H, Sq)
    assert torch.equal(plain, o32.to(torch.bfloat16))
    assert torch.equal(lse, ref.attention_lse_ref(q, k, causal=causal))
    c32, clse = ref.flash_attention_ref(q, k, v, causal=causal, stats=True, rows=7)
    torch.testing.assert_close(c32, o32, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(clse, lse, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ref.flash_attention_ref(q, k, v, causal=causal, rows=7).float(),
                               plain.float(), rtol=BF16_ULP, atol=1e-6)


def test_plain_backward_magnitudes_bound_the_gradients():
    """``magnitudes``: each element's sum over its terms' magnitudes is at
    least the gradient's own size, and a causal first query, whose dq
    cancels to roundoff, still has terms of the size of the others'."""
    B, Sq, Sk, H, KVH, Dh, causal = ATTN_CASES["causal GQA 8 over 2"]
    _, (q, k, v, do) = _attn_inputs(12, B, Sq, Sk, H, KVH, Dh, "float32")
    o32, lse = ref.flash_attention_ref(q, k, v, causal=True, stats=True)
    grads = ref.flash_attention_bwd_ref(q, k, v, o32, lse, do, causal=True)
    terms = ref.flash_attention_bwd_ref(q, k, v, o32, lse, do, causal=True, magnitudes=True)
    for g, t in zip(grads, terms):
        assert t.dtype == torch.float32 and t.shape == g.shape
        assert bool((g.abs() <= t * (1 + 1e-5) + 1e-7).all())
    dq, tq = grads[0][:, 0], terms[0][:, 0]
    assert float(dq.abs().max()) < 1e-5 * float(tq.abs().max())
    assert float(tq.abs().mean()) > 0.1 * float(terms[0].abs().mean())


def test_bf16_backward_needs_the_unrounded_output():
    """The rounding point the plain version and the kernel follow: D from
    the bf16-rounded output misses the reference, D from the f32 one
    meets it."""
    B, Sq, Sk, H, KVH, Dh, causal = ATTN_CASES["causal GQA 8 over 2"]
    (jq, jk, jv, jdo), (q, k, v, do) = _attn_inputs(3, B, Sq, Sk, H, KVH, Dh, "bfloat16")
    _, vjp = jax.vjp(partial(jax_layers.attention, causal=True), jq, jk, jv)
    want = vjp(jdo)
    o32, lse = ref.flash_attention_ref(q, k, v, causal=True, stats=True)
    _check_attention_grads(ref.flash_attention_bwd_ref(q, k, v, o32, lse, do, causal=True),
                           want, "bfloat16")
    rounded = ref.flash_attention_bwd_ref(q, k, v, o32.to(torch.bfloat16), lse, do,
                                          causal=True)
    with pytest.raises(AssertionError):
        _check_attention_grads(rounded, want, "bfloat16")


def test_flash_attention_fn_keeps_the_f32_output_and_lse_for_causal_gqa_bf16():
    """Through ``ops.flash_attention`` with grad: the forward keeps the f32
    output and the masked GQA log-sum-exp, and the backward gives the
    plain version's gradients bit for bit, dk and dv (B, Sk, KVH, Dh)."""
    _, (q, k, v, do) = _attn_inputs(4, 2, 24, 24, 8, 2, 32, "bfloat16")
    live = [t.clone().requires_grad_() for t in (q, k, v)]
    o = ops.flash_attention(*live, causal=True)
    assert "FlashAttentionFn" in type(o.grad_fn).__name__
    got = torch.autograd.grad(o, live, do)
    o32, lse = ref.flash_attention_ref(q, k, v, causal=True, stats=True)
    assert torch.equal(o.detach(), o32.to(torch.bfloat16))
    torch.testing.assert_close(lse, ref.attention_lse_ref(q, k, causal=True), rtol=0, atol=0)
    want = ref.flash_attention_bwd_ref(q, k, v, o32, lse, do, causal=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[1].shape == (2, 24, 2, 32)


# ---------------------------------------------------------------------------
# the smoke models
# ---------------------------------------------------------------------------
def _smoke(name):
    return jax_get_smoke(name), get_smoke(name)


def _jax_params(name, dtype, seed=0):
    jcfg, _ = _smoke(name)
    jp = jax_get_model(jcfg).init(jax.random.PRNGKey(seed), jcfg, dtype=DTYPES[dtype][0])
    if "cross" in jp:                     # the VLM's gates, off their zero init
        rng = np.random.default_rng(seed + 50)
        for g in ("gate_attn", "gate_mlp"):
            jp["cross"][g] = jnp.asarray(rng.uniform(0.3, 1.2, jp["cross"][g].shape),
                                         jnp.float32)
    return jp


def _batches(name, n, seed=0):
    """n (jax batch, torch batch) pairs: tokens and labels from the port's
    ``token_batches`` (the reference's stream), and the family's stub
    inputs drawn with numpy in bf16."""
    _, cfg = _smoke(name)
    it = token_batches(cfg.vocab_size, BATCH, SEQ, seed=seed)
    rng = np.random.default_rng(seed + 7)
    out = []
    for _ in range(n):
        tb = next(it)
        jb = {key: jnp.asarray(val.numpy()) for key, val in tb.items()}
        for key, shape, _dtype in get_model(cfg).extra_inputs:
            a = jnp.asarray(rng.standard_normal(shape(cfg, BATCH)), jnp.bfloat16)
            jb[key] = a
            tb[key] = _to_torch(a)
        out.append((jb, tb))
    return out


def _port_grads(params, batch, cfg, **kw):
    live = adamw.tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = get_model(cfg).loss_fn(live, batch, cfg, **kw)
    return loss.detach(), torch.autograd.grad(loss, adamw.tree_leaves(live))


# ---------------------------------------------------------------------------
# (2) step-0 gradients of loss_fn against jax.grad
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_fn_step0_gradients_match_jax_grad(name, dtype):
    jcfg, cfg = _smoke(name)
    jp = _jax_params(name, dtype)
    (jb, tb), = _batches(name, 1)
    jloss, jg = jax.value_and_grad(lambda p: jax_get_model(jcfg).loss_fn(p, jb, jcfg)[0])(jp)
    params = bridge.from_jax_params(jax.device_get(jp), device="cpu")
    loss, grads = _port_grads(params, tb, cfg)
    np.testing.assert_allclose(float(loss), float(jloss),
                               rtol=1e-5 if dtype == "float32" else 5e-2)
    rel, floor = GRAD_TOL[dtype]
    jleaves = jax.tree_util.tree_flatten_with_path(jg)[0]
    paths = [p for p, _ in flatten(params)[0]]
    assert len(jleaves) == len(grads) == len(paths)
    for (_, want), got, path, p in zip(jleaves, grads, paths, adamw.tree_leaves(params)):
        assert got.dtype == p.dtype and got.shape == p.shape, path
        want = _np(want)
        bound = rel * np.abs(want).max() + floor
        assert np.abs(_np(got) - want).max() <= bound, (path, np.abs(_np(got) - want).max(),
                                                         bound)
        assert bool(torch.isfinite(got).all()), path


# ---------------------------------------------------------------------------
# (3) lm_train_step against the reference's jitted step
# ---------------------------------------------------------------------------
def _jax_train_losses(jcfg, jp, batches, total):
    """The losses of the reference's ``train_lm`` step (value_and_grad of
    ``loss_fn``, clip at 1.0, AdamW at the cosine schedule), jitted, on
    ``batches``."""
    api = jax_get_model(jcfg)

    @jax.jit
    def step(params, opt, batch):
        loss, grads = jax.value_and_grad(lambda p: api.loss_fn(p, batch, jcfg)[0])(params)
        grads, _ = jax_adamw.clip_by_global_norm(grads, 1.0)
        lr = jax_adamw.cosine_schedule(opt.step, base_lr=3e-4, warmup=20, total=total)
        params, opt = jax_adamw.adamw_update(grads, opt, params, lr=lr)
        return params, opt, loss

    opt, losses = jax_adamw.adamw_init(jp), []
    for jb in batches:
        jp, opt, loss = step(jp, opt, jb)
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_train_step_losses_match_the_reference_step(name, dtype):
    jcfg, cfg = _smoke(name)
    jp = _jax_params(name, dtype)
    data = _batches(name, TRAIN_STEPS, seed=3)
    want = _jax_train_losses(jcfg, jp, [jb for jb, _ in data], TRAIN_STEPS)
    params = bridge.from_jax_params(jax.device_get(jp), device="cpu")
    opt = adamw.adamw_init(params)
    losses = []
    for _, tb in data:
        params, opt, m = lm_train_step(params, opt, tb, cfg, total=TRAIN_STEPS)
        assert all(v.grad_fn is None for v in m.values())
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL[dtype], atol=0)
    assert int(opt.step) == TRAIN_STEPS


# ---------------------------------------------------------------------------
# (4) the recompute changes no bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["qwen3-32b", "zamba2-7b", "seamless-m4t-large-v2",
                                  "llama-3.2-vision-11b"])
def test_remat_gives_the_same_gradients_bit_for_bit(name, monkeypatch):
    """``remat=True`` (the default) and ``remat=False`` give the same loss
    and gradients bit for bit, bf16; with it the attention forward runs
    again in the backward for every recomputed layer (zamba2: the
    superblocks; the VLM: the self layers, not the cross blocks)."""
    _, cfg = _smoke(name)
    params = bridge.from_jax_params(jax.device_get(_jax_params(name, "bfloat16")),
                                    device="cpu")
    (_, tb), = _batches(name, 1, seed=5)
    calls = []
    fwd = ops._flash_attention_fwd
    monkeypatch.setattr(ops, "_flash_attention_fwd",
                        lambda *a, **kw: calls.append(1) or fwd(*a, **kw))
    runs = {}
    for remat in (True, False):
        calls.clear()
        runs[remat] = _port_grads(params, tb, cfg, remat=remat), len(calls)
    (loss_r, grads_r), n_r = runs[True]
    (loss_p, grads_p), n_p = runs[False]
    assert torch.equal(loss_r, loss_p)
    assert all(torch.equal(a, b) for a, b in zip(grads_r, grads_p))
    recomputed = {"qwen3-32b": lambda: cfg.num_layers,
                  "zamba2-7b": lambda: cfg.num_layers // cfg.hybrid_attn_every,
                  "seamless-m4t-large-v2": lambda: cfg.encoder_layers + 2 * cfg.num_layers,
                  "llama-3.2-vision-11b": lambda: cfg.num_layers - cfg.num_layers
                  // cfg.cross_attn_every}[name]()
    assert n_r == n_p + recomputed


def test_remat_policies_other_than_full_raise():
    """``"dots"`` and ``"save_ffn"`` give ``"full"``'s loss and gradients bit
    for bit (they change only what the backward recomputes:
    ``tests/test_torch_remat_policy.py``); an unknown policy raises.  (The
    name is kept from when every policy but ``"full"`` raised.)"""
    _, cfg = _smoke("qwen3-32b")
    params = get_model(cfg).init(cfg, generator=torch.Generator().manual_seed(0))
    (_, tb), = _batches("qwen3-32b", 1)
    loss, grads = _port_grads(params, tb, cfg, remat_policy="full")
    for policy in ("dots", "save_ffn"):
        loss_p, grads_p = _port_grads(params, tb, cfg, remat_policy=policy)
        assert torch.equal(loss_p, loss)
        assert all(torch.equal(a, b) for a, b in zip(grads_p, grads))
    with pytest.raises(ValueError, match="remat_policy"):
        get_model(cfg).loss_fn(params, tb, cfg, remat_policy="none")


# ---------------------------------------------------------------------------
# (5) train_lm: the CLI on every LM family, the stub inputs, the cuts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES + ("gemma2-9b", "stablelm-12b", "qwen3-moe-30b-a3b",
                                          "dbrx-132b"))
def test_train_cli_trains_the_smoke_configs(name, capsys):
    params = train_cli.main(["--arch", name, "--smoke", "--device", "cpu", "--steps", "3",
                             "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    losses = [float(x) for x in re.findall(r"loss (\S+)", out)]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert all(bool(torch.isfinite(p).all()) for p in adamw.tree_leaves(params))


def test_stub_inputs_are_the_families_extra_inputs():
    for name, key in (("seamless-m4t-large-v2", "audio_frames"),
                      ("llama-3.2-vision-11b", "image_embeds"), ("qwen3-32b", None)):
        cfg = get_smoke(name)
        got = train_cli.stub_inputs(get_model(cfg), cfg, 3, torch.Generator().manual_seed(1))
        if key is None:
            assert got == {}
            continue
        n = cfg.num_audio_frames if key == "audio_frames" else cfg.num_image_tokens
        assert list(got) == [key]
        assert got[key].shape == (3, n, cfg.d_model) and got[key].dtype == torch.bfloat16
        again = train_cli.stub_inputs(get_model(cfg), cfg, 3, torch.Generator().manual_seed(1))
        assert torch.equal(got[key], again[key])



def test_profile_train_cuts_follow_each_family_s_layout():
    """``profile_train.lm_train_config`` (the depth phase 16b and the
    profile train at): seamless whole, encoder and decoder cut together
    when asked; zamba2's 12 blocks two superblocks of 5 + 1; the VLM's 5
    layers one superblock of 4 self layers and 1 cross; gemma2 at 4
    layers, two local and two global; stablelm 6; qwen3-moe 3 with all
    128 experts; every cut small enough for one 80 GB card."""
    from repro_torch.launch.profile_train import lm_train_config
    from repro_torch.models import dense, zamba2
    s = lm_train_config("seamless-m4t-large-v2")
    assert (s.num_layers, s.encoder_layers) == (24, 24)
    s = lm_train_config("seamless-m4t-large-v2", 4)
    assert (s.num_layers, s.encoder_layers) == (4, 4)
    z = lm_train_config("zamba2-7b")
    assert zamba2._layout(z) == (2, 5, 10, 0) and zamba2.num_attn_blocks(z) == 2
    v = lm_train_config("llama-3.2-vision-11b")
    assert v.num_layers // v.cross_attn_every == 1 and v.num_layers == 5
    q = lm_train_config("qwen3-32b")
    assert (q.num_layers, q.d_model, q.head_dim) == (2, 5120, 128)
    g = lm_train_config("gemma2-9b")
    assert (g.num_layers, g.d_model, g.head_dim) == (4, 3584, 256)
    assert dense.layer_windows(g) == [4096, None, 4096, None]
    assert lm_train_config("gemma2-9b", 2).num_layers == 2
    st = lm_train_config("stablelm-12b")
    assert (st.num_layers, st.head_dim) == (6, 160)
    m = lm_train_config("qwen3-moe-30b-a3b")
    assert (m.num_layers, m.num_experts, m.expert_d_ff) == (3, 128, 768)
    for cfg in (s, z, v, q, g, st, m):
        assert cfg.param_count() < 3.3e9     # about 21 bytes a param on 80 GB


def test_train_lm_refuses_only_a_mesh_before_any_init(monkeypatch):
    """The training meshes are ported (``tests/test_torch_train_mesh.py``);
    what a mesh still refuses, it refuses before any params are drawn: a
    batch that does not divide over the mesh's batch axes
    (``train_lm(mesh=)``) and ``--mesh prod`` on a world that is not 256
    ranks, both ``ValueError``; nothing else is refused
    (``refuse_untrainable`` is gone).  (The name is kept from when every
    mesh raised naming ROADMAP.)"""
    from repro_torch.launch.mesh import TrainMesh
    assert not hasattr(train_cli, "refuse_untrainable")

    def no_init(*a, **kw):
        raise AssertionError("params were drawn before the refusal")

    monkeypatch.setattr(train_cli, "get_model", no_init)
    with pytest.raises(ValueError, match="divide"):
        train_cli.train_lm(get_config("dbrx-132b"), steps=1, batch=3, seq=8, device="cpu",
                           mesh=TrainMesh(rank=0, data=2, model=1))
    for name in ("gemma2-9b", "stablelm-12b"):
        with pytest.raises(ValueError, match=r"\(16, 16\) = 256 ranks .* world size 1"):
            train_cli.main(["--arch", name, "--device", "cpu", "--steps", "1", "--mesh",
                            "prod"])


def test_ssd_scan_gradients_stay_finite_where_the_decays_underflow():
    """zamba2's ``_ssd_scan`` trains through autograd: with dt at 30 the
    segment sums reach -3,800 over a 128-step chunk, so most decays are
    exp of a huge negative number (0 in f32) and the masked ones exp of
    -inf; every input's gradient stays finite (a ``where`` whose unused
    branch overflowed would give 0 x inf = NaN), and the output's does
    not depend on the chunking (two 64-step chunks)."""
    from repro_torch.models import zamba2
    rng = np.random.default_rng(12)
    B, T, H, P, N = 1, 128, 2, 4, 3
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((B, T, H, P), (B, T, N), (B, T, N))]
    dt = torch.full((B, T, H), 30.0)
    A, D = torch.tensor([1.0, 0.5]), torch.tensor([1.0, 0.3])
    S0 = torch.from_numpy(rng.standard_normal((B, H, N, P)).astype(np.float32))
    grads = []
    for chunk in (128, 64):
        live = [t.clone().requires_grad_() for t in (*args, dt, A, D, S0)]
        y, S = zamba2._ssd_scan(*live[:3], live[3], live[4], live[5], live[6], chunk=chunk)
        g = torch.autograd.grad((y.sum() + S.sum()), live)
        assert all(bool(torch.isfinite(x).all()) for x in g)
        grads.append(g)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
