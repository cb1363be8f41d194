"""The port's DistriFusion patch parallelism against the JAX package's, on
the CPU, from the same numpy inputs.

``displaced_patch_attention`` (the replicated simulation) and
``sharded_patch_attention`` (one rank of a patch axis) are held against
the reference's functions; the reference's sharded form runs under
``jax.vmap`` with a named axis, which gives its ``all_gather`` and
``axis_index`` one shard per mapped row, and the port's against a mesh
stand-in whose all-gather returns every shard.  Uneven ``S`` (9 over 4)
checks the balanced owner map.  Then ``rf_sample`` with
``patch_parallel_ndev`` (2 and 4, the DistriFusion baseline under
``sync``) and with ``patch_compose`` (under ``dice`` + ``int8_residual``)
is held against the reference's ``rf_sample`` with the same arguments, on
the 2-layer config of ``tests/test_mesh_hierarchy.py`` at guidance 1.5, so
the conditional and unconditional passes keep separate K/V buffers.

Tolerances: TOL_F32 (rtol = atol = 1e-4: f32 end to end, sums in another
order); byte counts exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress.codecs import CompressConfig as JaxCompress
from repro.configs import dit_moe_xl as jax_configs
from repro.core import patch_parallel as jax_pp
from repro.core.schedules import DiceConfig as JaxDice
from repro.models.dit_moe import init_dit as jax_init_dit
from repro.sampling.rectified_flow import rf_sample as jax_rf_sample
from repro_torch import bridge
from repro_torch.compress.codecs import CompressConfig
from repro_torch.configs import dit_moe_xl as configs
from repro_torch.core import patch_parallel as pp
from repro_torch.core.schedules import DiceConfig
from repro_torch.kernels import ops
from repro_torch.sampling.rectified_flow import rf_sample

torch.set_num_threads(1)
TOL_F32 = dict(rtol=1e-4, atol=1e-4)
STEPS = 6


def _qkv(seed, B=2, S=9, H=4, KVH=2, Dh=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, Dh)).astype(np.float32),
            rng.standard_normal((B, S, KVH, Dh)).astype(np.float32),
            rng.standard_normal((B, S, KVH, Dh)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("S,n", [(16, 4), (8, 2), (9, 4), (5, 2), (7, 3),
                                 (17, 8), (256, 8)])
def test_shard_owner_and_bounds_match_the_reference(S, n):
    owner = pp.shard_owner(S, n)
    assert owner.tolist() == np.asarray(jax_pp.shard_owner(S, n)).tolist()
    bounds = pp.shard_bounds(S, n)
    assert [hi - lo for lo, hi in bounds] == \
        torch.bincount(owner, minlength=n).tolist()
    assert bounds[0][0] == 0 and bounds[-1][1] == S
    assert min(hi - lo for lo, hi in bounds) >= 1     # nobody starves


@pytest.mark.parametrize("warmup", [True, False])
def test_displaced_attention_matches_the_reference(warmup):
    q, k, v = _qkv(1)
    _, ks, vs = _qkv(2)                       # the previous step's buffer
    out, new = pp.displaced_patch_attention(
        *_t(q, k, v), pp.PatchParallelState(*_t(ks, vs)), n_dev=4,
        warmup=warmup)
    want, want_new = jax_pp.displaced_patch_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jax_pp.PatchParallelState(jnp.asarray(ks), jnp.asarray(vs)),
        n_dev=4, warmup=warmup)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL_F32)
    assert np.array_equal(new.k_prev.numpy(), np.asarray(want_new.k_prev))
    assert np.array_equal(new.v_prev.numpy(), np.asarray(want_new.v_prev))
    assert new.bytes() == want_new.bytes()
    # the buffers the launches read were given back: the state is intact
    assert np.array_equal(ks, _qkv(2)[1])


def test_displaced_attention_without_state_is_all_fresh():
    q, k, v = _qkv(3)
    cold, _ = pp.displaced_patch_attention(
        *_t(q, k, v), pp.PatchParallelState(), n_dev=4, warmup=False)
    want, _ = jax_pp.displaced_patch_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jax_pp.PatchParallelState(), n_dev=4, warmup=True)
    np.testing.assert_allclose(cold.numpy(), np.asarray(want), **TOL_F32)


def test_flash_attention_writes_into_a_given_view():
    """The displaced attention's launches write their rows of one output in
    place (``out=``, a strided view); a view of another shape is refused."""
    q, k, v = _t(*_qkv(6, S=8))
    out = torch.zeros_like(q)
    got = ops.flash_attention(q[:, 2:5], k, v, out=out[:, 2:5])
    assert got.data_ptr() == out[:, 2:5].data_ptr()
    assert torch.equal(out[:, 2:5], ops.flash_attention(q[:, 2:5], k, v))
    assert not out[:, :2].any() and not out[:, 5:].any()
    with pytest.raises(ValueError, match="out"):
        ops.flash_attention(q, k, v, out=out[:, :3])


class _PatchGroup:
    """A mesh stand-in for rank ``p`` of a patch axis of ``P``: its
    all-gather returns the given per-rank tensors, stacked along dim 0."""

    def __init__(self, p, P, shards):
        self.p, self.patch_size, self.shards = p, P, shards

    def rank_in(self, axis):
        return self.p if axis == "patch" else 0

    def patch_all_gather(self, t):
        assert torch.equal(t, self.shards[self.p])
        return torch.cat(self.shards)


def test_gather_patches_keeps_the_token_order():
    """Shards are stacked along dim 0; gathering must move that axis next
    to the tokens, not reshape it into them (which would interleave)."""
    x = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(2, 8, 3)
    shards = list(x.split(2, dim=1))
    for p in range(4):
        got = pp.gather_patches(shards[p], _PatchGroup(p, 4, shards))
        assert torch.equal(got, x)


@pytest.mark.parametrize("fresh", ["rows", True, False])
def test_sharded_patch_attention_matches_the_reference(fresh):
    P, S = 4, 8
    q, k, v = _qkv(4, S=S)
    _, ks, vs = _qkv(5, S=S)
    rows = np.array([True, False])
    sel = {"rows": rows, True: np.ones(2, bool), False: np.zeros(2, bool)}

    def ref(q_, k_, v_):
        out, new = jax_pp.sharded_patch_attention(
            q_, k_, v_, jax_pp.PatchParallelState(jnp.asarray(ks),
                                                  jnp.asarray(vs)),
            patch_axis="patch", fresh=jnp.asarray(sel[fresh]))
        return out, new.k_prev, new.v_prev

    def split(a):                            # (P, B, S / P, ...)
        return jnp.stack(jnp.split(jnp.asarray(a), P, axis=1))

    want, want_k, want_v = jax.vmap(ref, axis_name="patch")(
        split(q), split(k), split(v))
    kv = [torch.stack([a, b], dim=2) for a, b in
          zip(torch.from_numpy(k).split(S // P, 1),
              torch.from_numpy(v).split(S // P, 1))]
    for p in range(P):
        lo, hi = p * S // P, (p + 1) * S // P
        f = torch.from_numpy(sel[fresh])
        out, new = pp.sharded_patch_attention(
            *_t(q[:, lo:hi], k[:, lo:hi], v[:, lo:hi]),
            pp.PatchParallelState(*_t(ks, vs)), mesh=_PatchGroup(p, P, kv),
            fresh=f)
        np.testing.assert_allclose(out.numpy(), np.asarray(want[p]),
                                   **TOL_F32)
        assert np.array_equal(new.k_prev.numpy(), np.asarray(want_k[p]))
        assert np.array_equal(new.v_prev.numpy(), np.asarray(want_v[p]))
    # per row the displaced simulation's math: stale rows of other shards
    if fresh is False:
        full, _ = jax_pp.displaced_patch_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jax_pp.PatchParallelState(jnp.asarray(ks), jnp.asarray(vs)),
            n_dev=P, warmup=False)
        np.testing.assert_allclose(
            np.concatenate([np.asarray(w) for w in want], axis=1),
            np.asarray(full), **TOL_F32)


# ---------------------------------------------------------------------------
# rf_sample: the DistriFusion baseline and the composed simulation
# ---------------------------------------------------------------------------
def _jax_cfg():
    return jax_configs.tiny().replace(
        num_layers=2, d_model=64, moe_d_ff=64, d_ff=256, num_heads=4,
        num_kv_heads=4, head_dim=16, patch_tokens=16, capacity_factor=8.0)


def _cfg():
    return configs.tiny().replace(
        num_layers=2, d_model=64, moe_d_ff=64, d_ff=256, num_heads=4,
        num_kv_heads=4, head_dim=16, patch_tokens=16, capacity_factor=8.0)


@pytest.fixture(scope="module")
def jax_params():
    """The params of tests/test_mesh_hierarchy.py (adaLN and the output
    layer perturbed away from their zero init)."""
    params = jax_init_dit(jax.random.PRNGKey(0), _jax_cfg())
    k = jax.random.PRNGKey(99)
    for i, blk in enumerate(params["blocks"]):
        blk["adaln"] = 0.05 * jax.random.normal(jax.random.fold_in(k, i),
                                                blk["adaln"].shape)
    params["final_out"] = 0.05 * jax.random.normal(
        jax.random.fold_in(k, 10_000), params["final_out"].shape)
    return params


RUNS = {
    "distrifusion_2": (lambda: DiceConfig.sync_ep(), JaxDice.sync_ep,
                       2, False),
    "distrifusion_4": (lambda: DiceConfig.sync_ep(), JaxDice.sync_ep,
                       4, False),
    "compose_dice_int8": (
        lambda: DiceConfig.dice(compress=CompressConfig("int8_residual")),
        lambda: JaxDice.dice(compress=JaxCompress("int8_residual")), 2, True),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_rf_sample_patch_parallel_matches_the_reference(name, jax_params):
    mine, theirs, n_dev, compose = RUNS[name]
    cfg = _jax_cfg()
    key = jax.random.PRNGKey(7)
    classes = np.arange(8) % cfg.num_classes
    want, st = jax_rf_sample(jax_params, cfg, theirs(), num_steps=STEPS,
                             classes=jnp.asarray(classes), key=key,
                             guidance=1.5, patch_parallel_ndev=n_dev,
                             patch_compose=compose)
    noise = np.asarray(jax.random.normal(
        key, (8, cfg.patch_tokens, cfg.in_channels)))
    params = bridge.from_jax_params(jax.device_get(jax_params), device="cpu")
    got, stats = rf_sample(params, _cfg(), mine(), num_steps=STEPS,
                           classes=torch.as_tensor(classes),
                           noise=torch.as_tensor(noise), guidance=1.5,
                           patch_parallel_ndev=n_dev, patch_compose=compose)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_F32)
    assert stats["buffer_bytes"] == [float(b) for b in st["buffer_bytes"]]
    assert stats["dispatch_bytes"] == [float(b) for b in st["dispatch_bytes"]]
    assert stats["num_plan_variants"] == st["num_plan_variants"]
    # the K/V buffers of both passes are part of the footprint: two per
    # layer and pass, full sequence, on the conditional pass's count
    kv = 2 * 8 * cfg.patch_tokens * cfg.num_kv_heads * cfg.head_dim * 4
    assert stats["buffer_bytes"][-1] >= kv * cfg.num_layers


def test_distrifusion_reads_stale_keys_after_step_0(jax_params):
    """Remote patches are one step stale: with two simulated devices the
    samples differ from one device's, where every key is fresh, and at
    step 0 (no buffer yet) they agree."""
    cfg = _cfg()
    params = bridge.from_jax_params(jax.device_get(jax_params), device="cpu")
    noise = torch.randn((4, cfg.patch_tokens, cfg.in_channels),
                        generator=torch.Generator().manual_seed(0))
    kw = dict(classes=torch.arange(4), noise=noise, guidance=1.5)
    for steps, differ in ((1, False), (3, True)):
        one, _ = rf_sample(params, cfg, DiceConfig.sync_ep(),
                           num_steps=steps, patch_parallel_ndev=1, **kw)
        two, _ = rf_sample(params, cfg, DiceConfig.sync_ep(),
                           num_steps=steps, patch_parallel_ndev=2, **kw)
        err = float((two - one).abs().max())
        assert (err > 1e-6) == differ, (steps, err)
