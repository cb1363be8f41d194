"""The port's checkpoint I/O against the JAX package's, on the CPU.

Files cross both ways bit for bit (format 3, CRC32 after every chunk, and
the CRC-less formats 1 and 2 the reference still reads), the manifest's
msgpack subset packs and unpacks as the ``msgpack`` package does, the tree
structure string equals ``str(jax.tree_util.tree_structure)`` for the DiT
(tiny, and XL built from shapes alone) and RWKV-6 (smoke, bf16) trees,
and the port raises where the reference raises.  Then the paths that use
it: a ``DiceServer`` on weights the reference wrote serves the reference
server's samples within TOL (f32 end to end, sums in another order:
rtol 1e-4 / atol 1e-5), the CLI serves ``--ckpt``, and over 2 gloo ranks
each rank reads only its own experts.
"""
import io
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

import torch_ep_jobs as jobs
from repro.checkpoint import io as jio
from repro.compress.codecs import CompressConfig as JaxCompress
from repro.configs import dit_moe_xl as jax_configs
from repro.configs import rwkv6_3b as jax_rwkv_cfg
from repro.core.schedules import DiceConfig as JaxDice
from repro.launch import serve as jax_serve
from repro.models.dit_moe import init_dit as jax_init_dit
from repro.models.rwkv6 import init_rwkv6 as jax_init_rwkv6
from repro.resilience import FaultConfig as JaxFaultConfig
from repro.resilience import FaultPlan as JaxFaultPlan
from repro_torch import bridge
from repro_torch.checkpoint import io as tio
from repro_torch.checkpoint import msgpack_lite
from repro_torch.compress.codecs import CompressConfig
from repro_torch.configs import dit_moe_xl as configs
from repro_torch.core.schedules import DiceConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve
from repro_torch.models.dit_moe import init_dit
from repro_torch.resilience.faults import FaultConfig, FaultPlan

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:          # property tests need the dev extra
    HAVE_HYPOTHESIS = False

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-5)


def _np(tree):
    return jax.device_get(tree)


def _small_trees():
    """Name -> (JAX tree, chunk_bytes): the reference's own edge cases."""
    return {
        # 400 bytes through 64-byte chunks: 7 bins, one partial
        "multichunk": ({"big": jnp.arange(100, dtype=jnp.float32),
                        "small": jnp.ones((3,), jnp.float32)}, 64),
        # a 64-byte leaf through 64-byte chunks: the boundary on its end
        "boundary": ({"x": jnp.arange(16, dtype=jnp.float32),
                      "y": jnp.arange(3, dtype=jnp.int32)}, 64),
        "zero_size": ({"e": jnp.zeros((0, 4), jnp.float32),
                       "f": jnp.ones((2,), jnp.float32)}, 64),
        "dtypes": ({"a": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
                    "b": {"c": jnp.ones((2,), jnp.bfloat16),
                          "d": jnp.arange(5, dtype=jnp.int32)},
                    "g": [jnp.asarray(3, jnp.int8), jnp.ones((2, 2), bool)]},
                   tio.DEFAULT_CHUNK_BYTES),
    }


def _drawn(init, seed):
    """``init``'s tree (structure, shapes, dtypes from ``jax.eval_shape``)
    filled with seeded normal draws: the bytes, not the initializer, are
    what a checkpoint carries, and eager initializers compile per shape."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: jnp.asarray(rng.standard_normal(s.shape).astype(s.dtype)),
        jax.eval_shape(init))


@pytest.fixture(scope="module")
def trees():
    out = {k: v for k, v in _small_trees().items()}
    out["tiny_dit"] = (_drawn(lambda: jax_init_dit(
        jax.random.PRNGKey(0), jax_configs.tiny()), 0), 4096)
    out["rwkv6_smoke_bf16"] = (_drawn(lambda: jax_init_rwkv6(
        jax.random.PRNGKey(1), jax_rwkv_cfg.smoke()), 1), 8192)
    return out


def _leaves_equal(port_tree, jax_tree):
    mine = [t for _, t in tio.flatten(port_tree)[0]]
    ref = jax.tree_util.tree_leaves(jax_tree)
    assert len(mine) == len(ref)
    for m, r in zip(mine, ref):
        r = np.asarray(r)
        assert tuple(m.shape) == r.shape
        assert tio._leaf_meta(m)[0] == str(r.dtype)
        if r.dtype.name == "bfloat16":
            m, r = m.view(torch.int16).numpy(), r.view(np.int16)
        else:
            m = m.numpy()
        np.testing.assert_array_equal(m, r)


NAMES = ("multichunk", "boundary", "zero_size", "dtypes", "tiny_dit",
         "rwkv6_smoke_bf16")


@pytest.mark.parametrize("name", NAMES)
def test_reference_files_load_bit_equal(name, trees, tmp_path):
    tree, chunk = trees[name]
    path = str(tmp_path / "ref.ckpt")
    jio.save_checkpoint(path, tree, step=7, chunk_bytes=chunk)
    like = bridge._convert(_np(tree), torch.device("cpu"), "params")
    _leaves_equal(tio.load_checkpoint(path, like), tree)
    _leaves_equal({"leaves": list(tio.load_checkpoint_leaves(path, like))},
                  {"leaves": jax.tree_util.tree_leaves(tree)})
    man = tio.read_checkpoint_manifest(path)
    assert man == jio.read_checkpoint_manifest(path)
    assert (man["format"], man["step"], man["chunk_bytes"]) == (3, 7, chunk)


@pytest.mark.parametrize("name", NAMES)
def test_port_files_load_in_the_reference_bit_equal(name, trees, tmp_path):
    tree, chunk = trees[name]
    mine, ref = str(tmp_path / "port.ckpt"), str(tmp_path / "ref.ckpt")
    port_tree = bridge._convert(_np(tree), torch.device("cpu"), "params")
    tio.save_checkpoint(mine, port_tree, step=7, chunk_bytes=chunk)
    jio.save_checkpoint(ref, tree, step=7, chunk_bytes=chunk)
    with open(mine, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()          # the same bytes
    back = jio.load_checkpoint(mine, tree)
    for m, r in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        assert m.dtype == r.dtype
        np.testing.assert_array_equal(np.asarray(m).view(np.uint8),
                                      np.asarray(r).view(np.uint8))


@pytest.mark.parametrize("name", NAMES)
def test_msgpack_lite_agrees_with_msgpack_on_the_manifests(name, trees,
                                                           tmp_path):
    tree, chunk = trees[name]
    path = str(tmp_path / "ref.ckpt")
    jio.save_checkpoint(path, tree, chunk_bytes=chunk)
    with open(path, "rb") as f:
        man = msgpack.Unpacker(f, max_buffer_size=2**31).unpack()
    assert msgpack_lite.packb(man) == msgpack.packb(man)
    assert msgpack_lite.unpackb(msgpack.packb(man)) == man


if HAVE_HYPOTHESIS:
    _atoms = (st.none() | st.booleans()
              | st.integers(-2**63, 2**64 - 1) | st.text(max_size=300)
              | st.binary(max_size=300))
    _objs = st.recursive(
        _atoms, lambda c: st.lists(c, max_size=20)
        | st.dictionaries(st.text(max_size=20), c, max_size=20),
        max_leaves=40)

    @settings(max_examples=200, deadline=None)
    @given(obj=_objs)
    def test_msgpack_lite_property(obj):
        packed = msgpack_lite.packb(obj)
        assert packed == msgpack.packb(obj)
        assert msgpack_lite.unpackb(packed) == msgpack.unpackb(packed)


@pytest.mark.parametrize("n", [0, 31, 32, 255, 256, 65535, 65536])
def test_msgpack_lite_size_boundaries(n):
    """The length encodings change at these sizes (fixstr/str8/16/32,
    bin8/16/32, fixarray/array16/32, fixmap/map16/32)."""
    for obj in ("x" * n, b"y" * n, list(range(min(n, 70000))),
                {str(i): i for i in range(min(n, 70000))}):
        packed = msgpack_lite.packb(obj)
        assert packed == msgpack.packb(obj)
        assert msgpack_lite.unpackb(packed) == msgpack.unpackb(packed)


def test_msgpack_lite_refuses_what_it_does_not_cover():
    with pytest.raises(TypeError):
        msgpack_lite.packb(1.5)
    with pytest.raises(ValueError):
        msgpack_lite.unpackb(msgpack.packb(1.5))
    with pytest.raises(msgpack_lite.OutOfData):
        msgpack_lite.unpackb(msgpack.packb("abcdef")[:-2])


def _write_format1(path, tree, step=0):
    """tests/test_checkpoint.py's format-1 writer: no "format" key, one
    bin per leaf."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    manifest = {"step": step, "treedef": str(treedef),
                "leaves": [{"dtype": str(np.asarray(l).dtype),
                            "shape": list(np.asarray(l).shape)}
                           for l in leaves]}
    with open(path, "wb") as f:
        f.write(msgpack.packb(manifest))
        for l in leaves:
            f.write(msgpack.packb(np.asarray(jax.device_get(l)).tobytes()))


def _write_format2(path, tree, chunk_bytes=64):
    """Chunk bins without CRCs, as the reference wrote before format 3."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    raws = [np.asarray(l).tobytes() for l in leaves]
    manifest = {"format": 2, "step": 1, "treedef": str(treedef),
                "chunk_bytes": chunk_bytes,
                "leaves": [{"dtype": str(np.asarray(l).dtype),
                            "shape": list(np.asarray(l).shape),
                            "chunks": max(1, -(-len(r) // chunk_bytes))}
                           for l, r in zip(leaves, raws)]}
    with open(path, "wb") as f:
        f.write(msgpack.packb(manifest))
        for r in raws:
            for c in range(max(1, -(-len(r) // chunk_bytes))):
                f.write(msgpack.packb(r[c * chunk_bytes:(c + 1) * chunk_bytes]))


@pytest.mark.parametrize("fmt", [1, 2])
def test_old_formats_load(fmt, trees, tmp_path):
    tree = trees["dtypes"][0]
    path = str(tmp_path / "old.ckpt")
    (_write_format1 if fmt == 1 else _write_format2)(path, tree)
    like = bridge._convert(_np(tree), torch.device("cpu"), "params")
    assert tio.read_checkpoint_manifest(path)["format"] == fmt
    _leaves_equal(tio.load_checkpoint(path, like), tree)


def _outcome(fn):
    try:
        fn()
    except Exception as e:            # compared, never swallowed
        return type(e)
    return None


def _mutations():
    """(name, change to the like tree) pairs that must raise ValueError."""
    def treedef(t):
        t["zz"] = t["a"]
    def dtype(t):
        t["a"] = t["a"].astype(np.float16)
    def shape(t):
        t["a"] = t["a"].reshape(4, 3)
    return {"treedef": (treedef, "treedef"),
            "dtype": (dtype, "no silent cast"), "shape": (shape, "shape")}


@pytest.mark.parametrize("case", list(_mutations()))
def test_mismatched_like_raises_as_the_reference(case, trees, tmp_path):
    tree = dict(_np(trees["dtypes"][0]))
    tree["b"] = dict(tree["b"])
    path = str(tmp_path / "x.ckpt")
    jio.save_checkpoint(path, tree)
    change, match = _mutations()[case]
    like = dict(tree, b=dict(tree["b"]))
    change(like)
    with pytest.raises(ValueError, match=match):
        jio.load_checkpoint(path, like)
    with pytest.raises(ValueError, match=match):
        tio.load_checkpoint(path, bridge._convert(like, torch.device("cpu"),
                                                  "like"))


def test_wrong_leaf_count_raises(tmp_path):
    """A manifest with one leaf too many, its structure string unchanged:
    both packages raise on the count."""
    tree = {"a": np.arange(4, dtype=np.float32)}
    path = str(tmp_path / "x.ckpt")
    jio.save_checkpoint(path, tree)
    with open(path, "rb") as f:
        raw = f.read()
    man = jio.read_checkpoint_manifest(path)
    head = len(msgpack.packb(man))
    man["leaves"].append(dict(man["leaves"][0]))
    with open(path, "wb") as f:
        f.write(msgpack.packb(man) + raw[head:])
    with pytest.raises(ValueError, match="leaves"):
        jio.load_checkpoint(path, tree)
    with pytest.raises(ValueError, match="leaves"):
        tio.load_checkpoint(path, {"a": torch.zeros(4)})


def _flip(path, offset_from_end):
    with open(path, "r+b") as f:
        f.seek(-offset_from_end, os.SEEK_END)
        b = f.read(1)
        f.seek(-offset_from_end, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))


def test_corruption_raises_as_the_reference(tmp_path):
    """A flipped byte inside a chunk fails its CRC32 in both packages; a
    truncated file raises in both (the reference's msgpack raises its
    OutOfData, the port CheckpointCorruptionError, a ValueError); a
    FaultPlan truncation is detected as corruption by both."""
    tree = {"big": np.arange(100, dtype=np.float32),
            "small": np.ones((3,), np.float32)}
    like = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    path = str(tmp_path / "x.ckpt")
    jio.save_checkpoint(path, tree, chunk_bytes=64)
    _flip(path, 30)                          # inside "small"'s bytes
    with pytest.raises(jio.CheckpointCorruptionError, match="CRC32"):
        jio.load_checkpoint(path, tree)
    with pytest.raises(tio.CheckpointCorruptionError, match="CRC32"):
        tio.load_checkpoint(path, like)

    jio.save_checkpoint(path, tree, chunk_bytes=64)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 20)
    assert _outcome(lambda: jio.load_checkpoint(path, tree)) is \
        msgpack.OutOfData
    with pytest.raises(tio.CheckpointCorruptionError, match="truncated"):
        tio.load_checkpoint(path, like)

    jio.save_checkpoint(path, tree, chunk_bytes=64)
    for rate in (0.0, 1.0):
        mine = FaultPlan(FaultConfig(seed=7, checkpoint_truncate_rate=rate))
        ref = JaxFaultPlan(JaxFaultConfig(seed=7,
                                          checkpoint_truncate_rate=rate))
        got = _outcome(lambda: list(tio.load_checkpoint_leaves(
            path, like, fault_plan=mine)))
        want = _outcome(lambda: list(jio.load_checkpoint_leaves(
            path, tree, fault_plan=ref)))
        assert (got is None) == (want is None) == (rate == 0.0)
        if rate:
            assert got is tio.CheckpointCorruptionError
            assert want is jio.CheckpointCorruptionError
    assert issubclass(tio.CheckpointCorruptionError, ValueError)


def test_truncated_leaf_raises(tmp_path):
    """A manifest that claims more bytes than its bin holds (the
    reference's test_truncated_leaf_raises)."""
    path = str(tmp_path / "x.ckpt")
    manifest = {"format": 2, "step": 0, "treedef": "PyTreeDef({'x': *})",
                "chunk_bytes": 1024,
                "leaves": [{"dtype": "float32", "shape": [8], "chunks": 1}]}
    with open(path, "wb") as f:
        f.write(msgpack.packb(manifest))
        f.write(msgpack.packb(np.arange(4, dtype=np.float32).tobytes()))
    with pytest.raises(ValueError, match="truncated"):
        jio.load_checkpoint(path, {"x": np.zeros(8, np.float32)})
    with pytest.raises(tio.CheckpointCorruptionError, match="truncated"):
        tio.load_checkpoint(path, {"x": torch.zeros(8)})


@pytest.mark.parametrize("name", ["tiny", "config"])
def test_treedef_string_equals_jax_for_the_dit(name):
    """XL is built from shapes alone on both sides: ``jax.eval_shape`` and
    the port's meta-tensor tree."""
    jcfg = getattr(jax_configs, name)()
    jtree = jax.eval_shape(lambda: jax_init_dit(jax.random.PRNGKey(0), jcfg))
    like = init_dit(getattr(configs, name)(), generator=None)
    leaves, treedef = tio.flatten(like)
    assert treedef == str(jax.tree_util.tree_structure(jtree))
    assert all(t.device.type == "meta" for _, t in leaves)
    for (_, t), r in zip(leaves, jax.tree_util.tree_leaves(jtree)):
        assert tio._leaf_meta(t) == (str(r.dtype), tuple(r.shape))
    if name == "tiny":
        assert (len(treedef), len(leaves)) == (1547, 92)


def test_treedef_string_equals_jax_for_rwkv6(trees):
    tree = trees["rwkv6_smoke_bf16"][0]
    port = bridge.from_jax_params(_np(tree), device="cpu")
    assert tio.flatten(port)[1] == str(jax.tree_util.tree_structure(tree))


# ---------------------------------------------------------------------------
# serving from a checkpoint
# ---------------------------------------------------------------------------
def _cfgs():
    kw = dict(num_layers=2, d_model=64, moe_d_ff=64, d_ff=256,
              patch_tokens=16, capacity_factor=8.0)
    return jax_configs.tiny().replace(**kw), configs.tiny().replace(**kw)


@pytest.fixture(scope="module")
def dit_params():
    """The served DiT's reference params, adaLN-zero de-degenerated."""
    params = jax_init_dit(jax.random.PRNGKey(0), _cfgs()[0])
    k = jax.random.PRNGKey(99)
    for i, blk in enumerate(params["blocks"]):
        blk["adaln"] = 0.05 * jax.random.normal(jax.random.fold_in(k, i),
                                                blk["adaln"].shape)
    params["final_out"] = 0.05 * jax.random.normal(
        jax.random.fold_in(k, 10_000), params["final_out"].shape)
    return params


def test_server_on_reference_weights_serves_the_reference_samples(
        dit_params, tmp_path):
    """The path --ckpt takes: the reference writes, the port reads (into
    a meta-tensor like tree) and serves dice + int8; the reference serves
    the same file with the same noise."""
    jcfg, cfg = _cfgs()
    params = dit_params
    path = str(tmp_path / "dit.ckpt")
    jio.save_checkpoint(path, params, chunk_bytes=1 << 16)

    reqs = [(1, 0), (3, 1)]
    key = jax.random.PRNGKey(5)
    jserver = jax_serve.DiceServer(
        jcfg, JaxDice.dice(), params=jio.load_checkpoint(path, params),
        compress=JaxCompress("int8_residual"))
    want, _ = jserver.generate([jax_serve.Request(c, r) for c, r in reqs],
                               num_steps=4, key=key)
    noise = np.asarray(jax.random.normal(key, (2, cfg.patch_tokens,
                                               cfg.in_channels)))
    loaded = tio.load_checkpoint(path, init_dit(cfg, generator=None),
                                 device="cpu")
    server = serve.DiceServer(cfg, DiceConfig.dice(), params=loaded,
                              device="cpu",
                              compress=CompressConfig("int8_residual"))
    got, _ = server.generate([serve.Request(c, r) for c, r in reqs],
                             num_steps=4, noise=torch.from_numpy(noise.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(np.abs(np.asarray(want) - noise).max()) > 0.01


def test_a_meta_like_tree_loads_on_the_card_unless_told(tmp_path,
                                                        monkeypatch):
    """With meta tensors for ``like`` the leaves go where the caller says;
    with no device they go to ``cuda``, and without a card that raises
    rather than leaving the weights on the host."""
    path = str(tmp_path / "small.ckpt")
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": torch.ones(4, dtype=torch.bfloat16)}
    tio.save_checkpoint(path, tree)
    like = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in tree.items()}
    got = tio.load_checkpoint(path, like, device="cpu")
    for k in tree:
        assert got[k].device.type == "cpu" and torch.equal(got[k], tree[k])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tio.load_checkpoint(path, like)


def test_cli_serves_a_checkpoint(tmp_path):
    path = str(tmp_path / "tiny.ckpt")
    jio.save_checkpoint(path, jax_init_dit(jax.random.PRNGKey(3),
                                           jax_configs.tiny()))
    buf = io.StringIO()
    with redirect_stdout(buf):
        serve.main(["--device", "cpu", "--requests", "2", "--steps", "2",
                    "--ckpt", path])
    out = buf.getvalue()
    assert f"weights from {path}" in out
    assert "samples: (2, 64, 4), finite=True" in out
    assert "wall_s_per_step" in out
    bad = str(tmp_path / "other.ckpt")
    jio.save_checkpoint(bad, {"x": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="treedef"):
        serve.main(["--device", "cpu", "--ckpt", bad])


def test_each_rank_reads_its_own_experts(dit_params, tmp_path):
    """2 gloo ranks stream one file; each keeps rows [r e_loc, (r+1) e_loc)
    of every experts_* leaf and the whole of every other leaf."""
    cfg = _cfgs()[1]
    params = _np(dit_params)
    path = str(tmp_path / "dit.ckpt")
    jio.save_checkpoint(path, params)
    got, _ = mesh_lib.spawn(jobs.checkpoint_slices, 2, backend="gloo",
                            device="cpu", timeout_s=120,
                            args=(path, cfg))
    full = tio.flatten(bridge.from_jax_params(params, device="cpu"))[0]
    e_loc = cfg.num_experts // 2
    for rank, leaves in enumerate(got):
        assert [p for p, _ in leaves] == [p for p, _ in full]
        for (p, t), (_, ref) in zip(leaves, full):
            if p.rsplit(".", 1)[-1].startswith("experts_"):
                ref = ref[rank * e_loc:(rank + 1) * e_loc]
            assert torch.equal(t, ref), (rank, p)


def test_tree_walks_hold_no_reference_cycle():
    """ROADMAP C.13: ``flatten``, ``unflatten`` and ``bridge.leaves`` leave
    nothing in a reference cycle, so a leaf (a train step's gradient) is
    freed with its last reference, not at the collector's next pass."""
    import gc
    import weakref
    was = gc.isenabled()
    gc.disable()
    try:
        like = {"a": {"b": [torch.ones(3), (torch.zeros(2),)], "c": None}}
        rebuilt = tio.unflatten(like, [torch.full((4,), 7.0), torch.ones(1)])
        leaves, structure = tio.flatten(rebuilt)
        flat = bridge.leaves(rebuilt)
        assert structure == "PyTreeDef({'a': {'b': [*, (*,)], 'c': None}})"
        assert [p for p, _ in leaves] == [".a.b[0]", ".a.b[1][0]"]
        assert list(flat) == ["a.b[0]", "a.b[1][0]", "a.c"]
        probe = weakref.ref(rebuilt["a"]["b"][0])
        del rebuilt, leaves, flat
        assert probe() is None
    finally:
        if was:
            gc.enable()
