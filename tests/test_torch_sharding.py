"""The port's ``("data", "model")`` meshes and sharding rules
(``repro_torch.launch.mesh`` / ``sharding``), ``compressed_psum`` and
``CheckpointManager``'s elastic restore, against the reference.

- Spec trees: every spec builder against the reference's for every config
  of ``repro.configs`` at smoke and full shape, on a local (2, 4) mesh and
  the two production meshes. The reference reads only a mesh's axis names,
  shape and device count, so it gets a stand-in object; its parameter
  shapes come from ``jax.eval_shape``, the port's from the same model built
  on the meta device (``convert.lm_param_shapes`` / ``*_params_to_tree``).
  Specs compare as tuples, leaf by leaf by path.
- Placement, ``compressed_psum`` and a checkpoint the reference saves from
  a sharded tree come from a subprocess with 8 forced host devices and
  Auto axes (:func:`dump_reference`): each coordinate's block against the
  reference's ``devices_indices_map``, exactly; the compressed sum within
  rtol 1e-6 (the int8 payloads are equal; only the order of the four
  scales' sum may differ), the new residuals within 1e-6 of the corrected
  gradient's largest entry; restored leaves bit for bit.
"""
import os
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.launch import sharding as ref_shr  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.models.gnn import dimenet as ref_dimenet  # noqa: E402
from repro.models.gnn import gin as ref_gin  # noqa: E402
from repro.models.gnn import graphcast as ref_graphcast  # noqa: E402
from repro.models.gnn import mace as ref_mace  # noqa: E402
from repro.models.recsys import autoint as ref_autoint  # noqa: E402
from repro.train import compression as ref_comp  # noqa: E402
from repro_torch import launch  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    gnn_params_to_tree,
    lm_param_shapes,
    recsys_params_to_tree,
)
from repro_torch.launch import (  # noqa: E402
    Mesh,
    NamedSharding,
    P,
    check_specs,
    gather,
    make_local_mesh,
    make_production_mesh,
    place,
    shardings_from_specs,
)
from repro_torch.launch.sharding import spec_leaves  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.gnn import dimenet, gin, graphcast, mace  # noqa: E402
from repro_torch.models.recsys.autoint import AutoInt  # noqa: E402
from repro_torch.train import compression as comp  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
LMS = ["yi_6b", "granite_8b", "nemotron_4_15b", "deepseek_v2_lite_16b", "deepseek_v2_236b"]
GNNS = ["gin_tu", "graphcast", "dimenet", "mace"]
MESH_SHAPES = {"local": ((2, 4), ("data", "model")),
               "production": ((16, 16), ("data", "model")),
               "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}
# (shape, spec) cases whose blocks are held against the reference's
# devices_indices_map on a (2, 4) mesh and a (2, 2, 2) one
PLACE_CASES = [((8, 12), ("data", "model")), ((8, 12), ("model", None)),
               ((16, 3), (("data", "model"), None)), ((4, 8, 6), (None, "model", "data")),
               ((6, 5), ()), ((8, 4), (("model", "data"),))]
PLACE_CASES_3D = [((8, 4), (("pod", "data"), "model")), ((4, 6), ("model", None))]
PSUM_SHARDS = 4
PSUM_SCALES = (1.0, 2.1, 3.7, 0.4)


# --------------------------------------------------------------------------
# the reference's values that need a mesh of devices
# --------------------------------------------------------------------------
def _auto_mesh(shape, axes):
    devs = np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return jax.sharding.Mesh(devs, axes, axis_types=(jax.sharding.AxisType.Auto,) * len(axes))


def _psum_inputs():
    """Per-shard gradient and residual trees (numpy, a leading shard axis)
    whose shards have unequal scales."""
    rng = np.random.default_rng(7)
    scale = np.asarray(PSUM_SCALES, np.float32)
    g = {"a": (rng.standard_normal((PSUM_SHARDS, 3, 5)) * scale[:, None, None]),
         "b": (rng.standard_normal((PSUM_SHARDS, 7)) * scale[:, None])}
    r = {"a": rng.standard_normal((PSUM_SHARDS, 3, 5)) * 1e-3,
         "b": rng.standard_normal((PSUM_SHARDS, 7)) * 1e-3}
    f32 = lambda t: {k: v.astype(np.float32) for k, v in t.items()}  # noqa: E731
    return f32(g), f32(r)


def _ckpt_tree():
    """The tree the reference saves from a sharded layout: f32 rows split
    over 8 data coordinates, a bf16 leaf split by column, a replicated one."""
    return {"w": np.arange(64, dtype=np.float32).reshape(8, 8),
            "e": (np.arange(32, dtype=np.float32).reshape(4, 8) / 7.0),
            "step_stats": np.asarray([3.0, 4.0], np.float32)}


def reference_values(ckpt_dir: str) -> dict:
    from jax.sharding import NamedSharding as RefNamed
    from jax.sharding import PartitionSpec as RefP

    from repro.train.checkpoint import CheckpointManager as RefManager
    from repro.utils import shard_map_compat as shard_map

    out = {}
    for cases, shape, axes in ((PLACE_CASES, (2, 4), ("data", "model")),
                               (PLACE_CASES_3D, (2, 2, 2), ("pod", "data", "model"))):
        mesh = _auto_mesh(shape, axes)
        for i, (arr_shape, spec) in enumerate(cases):
            idx = RefNamed(mesh, RefP(*spec)).devices_indices_map(arr_shape)
            out[f"place/{len(shape)}/{i}"] = np.asarray(
                [[(s.start or 0, arr_shape[d] if s.stop is None else s.stop)
                  for d, s in enumerate(idx[dev])] for dev in mesh.devices.flat])
    g, r = _psum_inputs()
    mesh4 = _auto_mesh((PSUM_SHARDS,), ("data",))

    def body(g, r):
        g = jax.tree.map(lambda a: a[0], g)
        r = jax.tree.map(lambda a: a[0], r)
        deq, rs = ref_comp.compressed_psum(g, r, "data")
        return deq, jax.tree.map(lambda a: a[None], rs)

    deq, rs = jax.jit(shard_map(body, mesh=mesh4, in_specs=(RefP("data"), RefP("data")),
                                out_specs=(RefP(), RefP("data"))))(g, r)
    for k in g:
        out[f"psum/deq/{k}"], out[f"psum/rs/{k}"] = np.asarray(deq[k]), np.asarray(rs[k])
    mesh8 = _auto_mesh((8,), ("data",))
    tree = _ckpt_tree()
    RefManager(ckpt_dir).save(3, {
        "w": jax.device_put(tree["w"], RefNamed(mesh8, RefP("data", None))),
        "e": jax.device_put(jnp.asarray(tree["e"], jnp.bfloat16),
                            RefNamed(mesh8, RefP(None, "data"))),
        "step_stats": jnp.asarray(tree["step_stats"])}, blocking=True)
    return out


def dump_reference(path: str, ckpt_dir: str) -> None:
    """Entry point of the subprocess: :func:`reference_values` to ``path``."""
    assert jax.device_count() >= 8, jax.devices()
    np.savez(path, **reference_values(ckpt_dir))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """(the reference's values, the directory of its sharded checkpoint)."""
    d = tmp_path_factory.mktemp("sharding_ref")
    path, ckpt = str(d / "ref.npz"), str(d / "ckpt")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(HERE, "..", "src"), HERE]))
    code = f"import test_torch_sharding as t\nt.dump_reference({path!r}, {ckpt!r})\n"
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=HERE, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    with np.load(path) as f:
        return dict(f), ckpt


# --------------------------------------------------------------------------
# meshes
# --------------------------------------------------------------------------
def _cpu_mesh(shape, axes):
    return Mesh(np.array(["cpu"] * int(np.prod(shape)), dtype=object).reshape(shape), axes)


def test_local_and_production_meshes():
    m = make_local_mesh(data=2, model=4, devices=["cpu"] * 8)
    assert m.axis_names == ("data", "model") and m.shape == {"data": 2, "model": 4}
    assert m.size == 8 and m.devices.shape == (2, 4) and m.device_type == "cpu"
    assert m.physical_devices() == (torch.device("cpu"),) and m.stages_per_device() == 8
    assert make_local_mesh(model=4, devices=["cpu"] * 8) == m  # data from the devices
    assert hash(make_local_mesh(model=4, devices=["cpu"] * 8)) == hash(m)
    assert make_local_mesh(data=1, model=2, devices=["cpu"] * 8).size == 2  # the first ones
    for multi, shape, axes in ((False, (16, 16), ("data", "model")),
                               (True, (2, 16, 16), ("pod", "data", "model"))):
        pm = make_production_mesh(multi_pod=multi, devices=["cpu"] * int(np.prod(shape)))
        assert pm.axis_names == axes and tuple(pm.shape.values()) == shape
        assert launch.data_parallel_axes(pm) == axes[:-1]
    ring = launch.flat_ring(_cpu_mesh((2, 2, 2), ("pod", "data", "model")))
    assert ring.size == 8 and launch.flat_ring(ring) is ring


def test_mesh_builders_raise_rather_than_wrap():
    """Without devices a builder takes CUDA cards and raises with fewer (none
    here); a given list must hold enough; a mesh has one device type."""
    with pytest.raises(ValueError, match="needs 8 CUDA devices"):
        make_local_mesh(data=2, model=4)
    with pytest.raises(ValueError, match="needs 256 CUDA devices"):
        make_production_mesh()
    with pytest.raises(ValueError, match="needs 8 devices, found 4"):
        make_local_mesh(data=2, model=4, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="exactly 512"):
        make_production_mesh(multi_pod=True, devices=["cpu"] * 256)
    with pytest.raises(ValueError, match="at least one coordinate"):
        make_local_mesh(model=0, devices=["cpu"])
    with pytest.raises(ValueError, match="share a device type"):
        Mesh([["cpu", "meta"]], ("data", "model"))
    with pytest.raises(ValueError, match="axis names"):
        Mesh([["cpu", "cpu"]], ("data",))
    with pytest.raises(ValueError, match="distinct"):
        Mesh([["cpu", "cpu"]], ("data", "data"))


def test_data_model_grid_orders_rows_major_over_the_data_axes():
    """Row r of a (pod, data, model) mesh is pod r // 2, data r % 2; the
    model axis may stand anywhere."""
    devs = np.array([torch.device("cpu", i) for i in range(8)], dtype=object)
    m = Mesh(devs.reshape(2, 2, 2), ("pod", "data", "model"))
    grid = launch.data_model_grid(m)
    assert grid.shape == (4, 2) and [d.index for d in grid[:, 0]] == [0, 2, 4, 6]
    mt = Mesh(devs.reshape(2, 4), ("model", "data"))
    assert [d.index for d in launch.data_model_grid(mt)[1]] == [1, 5]


# --------------------------------------------------------------------------
# PartitionSpec, NamedSharding, place / gather
# --------------------------------------------------------------------------
def test_partition_spec_reads_like_the_reference():
    from jax.sharding import PartitionSpec as RefP

    for spec in ((), ("data", None), (("pod", "data"), "model", None)):
        assert tuple(P(*spec)) == tuple(RefP(*spec)) == P(*spec)
    assert P("data") != P("data", None) and len(P(None, "model")) == 2
    assert launch.named(_cpu_mesh((2, 4), ("data", "model")), "data").spec == P("data")
    with pytest.raises(ValueError, match="axis name"):
        P(3)
    with pytest.raises(ValueError, match="by string"):
        P(("data", 1))


def test_named_sharding_refuses_what_the_reference_refuses():
    m = _cpu_mesh((2, 4), ("data", "model"))
    with pytest.raises(ValueError, match="not in the mesh"):
        NamedSharding(m, P("pod", None))
    with pytest.raises(ValueError, match="more than one dim"):
        NamedSharding(m, P("data", "data"))
    s = NamedSharding(m, P("data", "model", None))
    with pytest.raises(ValueError, match="3 entries"):
        s.check((4, 8))
    s.check((3, 5, 7), even=False)  # a constraint pads an uneven dim
    with pytest.raises(ValueError, match="does not divide"):
        s.check((3, 8, 1))
    assert s.shard_shape((4, 8, 3)) == (2, 2, 3)


@pytest.mark.parametrize("case", range(len(PLACE_CASES) + len(PLACE_CASES_3D)))
def test_place_puts_the_references_blocks(ref, case):
    """Each coordinate's block equals the reference's devices_indices_map;
    gather undoes place; replicating coordinates share one copy per device."""
    values, _ = ref
    if case < len(PLACE_CASES):
        (shape, spec), mshape, axes, key = PLACE_CASES[case], (2, 4), ("data", "model"), \
            f"place/2/{case}"
    else:
        i = case - len(PLACE_CASES)
        (shape, spec), mshape, axes, key = PLACE_CASES_3D[i], (2, 2, 2), \
            ("pod", "data", "model"), f"place/3/{i}"
    mesh = _cpu_mesh(mshape, axes)
    t = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    placed = place(t, NamedSharding(mesh, P(*spec)))
    want = values[key]
    for c, coord in enumerate(np.ndindex(mshape)):
        blk = tuple(slice(a, b) for a, b in want[c])
        assert torch.equal(placed.shards[coord], t[blk]), (coord, spec)
    assert torch.equal(gather(placed), t) and placed.shape == shape
    n_blocks = len({tuple(map(tuple, w)) for w in want})
    assert len({id(s) for s in placed.shards.flat}) == n_blocks


def test_place_refuses_a_dim_that_does_not_divide():
    m = _cpu_mesh((2, 4), ("data", "model"))
    with pytest.raises(ValueError, match="does not divide"):
        place(torch.zeros(6, 6), NamedSharding(m, P("data", "model")))
    with pytest.raises(ValueError, match="entries"):
        place(torch.zeros(8), NamedSharding(m, P("data", "model")))


def test_placed_shards_are_copies():
    m = _cpu_mesh((2,), ("data",))
    t = torch.zeros(4, 2)
    placed = place(t, NamedSharding(m, P("data")))
    t += 1
    assert not gather(placed).any()


# --------------------------------------------------------------------------
# spec trees against the reference's
# --------------------------------------------------------------------------
def _ref_mesh(name):
    shape, axes = MESH_SHAPES[name]
    return types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)),
                                 devices=np.empty(shape, dtype=object))


def _ref_specs(tree):
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(s)
            for path, s in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_p)[0]}


def _port_specs(tree):
    return {path: tuple(s) for path, s in spec_leaves(tree)}


def _same(port_tree, ref_tree):
    got, want = _port_specs(port_tree), _ref_specs(ref_tree)
    assert sorted(got) == sorted(want)
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, list(bad.items())[:5]


def _configs(arch, size):
    return (ref_get_smoke(arch), get_smoke(arch)) if size == "smoke" else \
        (ref_get_config(arch), get_config(arch))


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", LMS)
def test_lm_specs_match_reference(arch, size):
    """lm_param_specs, opt_state_specs and lm_cache_specs (batch 1, which
    replicates, and 32) on all three meshes."""
    cfg, pcfg = _configs(arch, size)
    shapes = jax.eval_shape(lambda: ref_tf.init_params(jax.random.PRNGKey(0), cfg))
    pshapes = lm_param_shapes(tf.Transformer(pcfg, device="meta"), pcfg)
    for name, (mshape, axes) in MESH_SHAPES.items():
        rm, pm = _ref_mesh(name), _cpu_mesh(mshape, axes)
        specs = launch.lm_param_specs(pshapes, pm)
        _same(specs, ref_shr.lm_param_specs(shapes, rm))
        _same(launch.opt_state_specs(specs),
              ref_shr.opt_state_specs(ref_shr.lm_param_specs(shapes, rm)))
        check_specs(specs, pshapes, pm)
        for b in (1, 32):
            cache = jax.eval_shape(lambda: ref_tf.cache_init(cfg, b, 64))
            pcache = tf.cache_init(pcfg, b, 64, device="meta")
            _same(launch.lm_cache_specs(pcache, pm), ref_shr.lm_cache_specs(cache, rm))
        _same(launch.lm_batch_specs(pm), ref_shr.lm_batch_specs(rm))
        _same(launch.recsys_batch_specs(pm), ref_shr.recsys_batch_specs(rm))


_GNN_PORT = {"gin": lambda cfg: gin.GIN(cfg, 100, device="meta"),
             "graphcast": lambda cfg: graphcast.GraphCast(cfg, device="meta"),
             "dimenet": lambda cfg: dimenet.DimeNet(cfg, 16, device="meta"),
             "mace": lambda cfg: mace.MACE(cfg, 16, device="meta")}
_GNN_REF = {"gin": lambda k, cfg: ref_gin.init_params(k, cfg, d_in=100),
            "graphcast": ref_graphcast.init_params, "dimenet": ref_dimenet.init_params,
            "mace": ref_mace.init_params}


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", GNNS)
def test_gnn_param_specs_match_reference(arch, size):
    cfg, pcfg = _configs(arch, size)
    shapes = jax.eval_shape(lambda: _GNN_REF[cfg.family](jax.random.PRNGKey(0), cfg))
    pshapes = gnn_params_to_tree(_GNN_PORT[cfg.family](pcfg), pcfg)
    for name, (mshape, axes) in MESH_SHAPES.items():
        _same(launch.gnn_param_specs(pshapes, _cpu_mesh(mshape, axes)),
              ref_shr.gnn_param_specs(shapes, _ref_mesh(name)))


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_recsys_param_specs_match_reference(size):
    cfg, pcfg = _configs("autoint", size)
    shapes = jax.eval_shape(lambda: ref_autoint.init_params(jax.random.PRNGKey(0), cfg))
    pshapes = recsys_params_to_tree(AutoInt(pcfg, device="meta"), pcfg)
    for name, (mshape, axes) in MESH_SHAPES.items():
        _same(launch.recsys_param_specs(pshapes, _cpu_mesh(mshape, axes)),
              ref_shr.recsys_param_specs(shapes, _ref_mesh(name)))


@pytest.mark.parametrize("n", [1024, 1000], ids=["divides", "replicates"])
def test_gnn_batch_specs_match_reference(n):
    """Node, edge, triplet and sampled-block arrays; a leading dim that does
    not divide stays replicated; an int passes as P()."""
    shapes = {"x": (n, 16), "pos": (n, 3), "z": (n,), "labels": (n,), "graph_ids": (n,),
              "target": (1,), "edges": (4 * n, 2), "triplets": (2 * n, 2)}
    blocks = [{"src_idx": (n,), "dst_index": (n,), "mask": (n,)},
              {"src_idx": (n // 4,), "dst_index": (n // 4,), "mask": (n // 4,)}]
    sds = lambda s: jax.ShapeDtypeStruct(s, jnp.float32)  # noqa: E731
    meta = lambda s: torch.empty(s, device="meta")  # noqa: E731
    rb = {k: sds(s) for k, s in shapes.items()}
    rb["blocks"] = [{k: sds(s) for k, s in b.items()} for b in blocks]
    rb["n_graphs"] = 5
    pb = {k: meta(s) for k, s in shapes.items()}
    pb["blocks"] = [{k: meta(s) for k, s in b.items()} for b in blocks]
    pb["n_graphs"] = 5
    for name, (mshape, axes) in MESH_SHAPES.items():
        _same(launch.gnn_batch_specs(pb, _cpu_mesh(mshape, axes)),
              ref_shr.gnn_batch_specs(rb, _ref_mesh(name)))


def test_shardings_from_specs_and_check_specs():
    pcfg = get_smoke("deepseek_v2_lite_16b")
    m = _cpu_mesh((2, 4), ("data", "model"))
    shapes = lm_param_shapes(tf.Transformer(pcfg, device="meta"), pcfg)
    specs = launch.lm_param_specs(shapes, m)
    sh = shardings_from_specs(m, specs)
    assert [(k, s.spec) for k, s in spec_leaves(sh)] == spec_leaves(specs)
    assert all(s.mesh is m for _, s in spec_leaves(sh))
    bad = dict(specs)
    del bad["embed"]
    with pytest.raises(ValueError, match="does not match"):
        check_specs(bad, shapes, m)
    with pytest.raises(ValueError, match="embed"):
        check_specs({**specs, "embed": P(None, None, "model")}, shapes, m)
    with pytest.raises(ValueError, match="not in the mesh"):
        check_specs(specs, shapes, _cpu_mesh((8,), ("data",)))


# --------------------------------------------------------------------------
# compressed_psum
# --------------------------------------------------------------------------
def test_compressed_psum_matches_reference_inside_shard_map(ref):
    """Four data shards with unequal scales: the int32 sum times the mean
    scale, equal on every index, and each index's residual."""
    values, _ = ref
    g, r = _psum_inputs()
    mesh = _cpu_mesh((PSUM_SHARDS, 2), ("data", "model"))
    grads = [{k: torch.from_numpy(v[i].copy()) for k, v in g.items()} for i in range(PSUM_SHARDS)]
    res = [{k: torch.from_numpy(v[i].copy()) for k, v in r.items()} for i in range(PSUM_SHARDS)]
    deq, rs = comp.compressed_psum(grads, res, "data", mesh=mesh)
    for k in g:
        for i in range(PSUM_SHARDS):
            np.testing.assert_allclose(deq[i][k].numpy(), values[f"psum/deq/{k}"], rtol=1e-6,
                                       atol=1e-7)
            # a residual is corrected - q·s, a difference of near-equal floats:
            # held to float32 rounding of the corrected gradient (XLA may fuse
            # the product into the subtraction)
            np.testing.assert_allclose(rs[i][k].numpy(), values[f"psum/rs/{k}"][i], rtol=0,
                                       atol=1e-6 * np.abs(g[k][i] + r[k][i]).max())
            assert torch.equal(deq[i][k], deq[0][k])
    # the mean scale is not the mean gradient: the scales differ by 9x here
    mean = np.mean(g["a"] + r["a"], axis=0)
    assert np.abs(deq[0]["a"].numpy() - mean).max() > 10 * np.abs(
        np.asarray(values["psum/deq/a"]) - deq[0]["a"].numpy()).max()


def test_compressed_psum_refuses_a_tree_count_that_is_not_the_axis():
    mesh = _cpu_mesh((4, 2), ("data", "model"))
    g = [{"w": torch.ones(3)}] * 3
    with pytest.raises(ValueError, match="4 indices"):
        comp.compressed_psum(g, g, "data", mesh=mesh)
    with pytest.raises(ValueError, match="no axis"):
        comp.compressed_psum(g, g, "pod", mesh=mesh)


# --------------------------------------------------------------------------
# elastic restore
# --------------------------------------------------------------------------
def test_elastic_restore_from_eight_coordinates_onto_four(tmp_path):
    """tests/test_elastic_restore.py's case in the port: rows placed on an
    8-coordinate mesh, saved, restored onto 4 with shardings; a placed like
    leaf without a sharding keeps its own."""
    m8, m4 = _cpu_mesh((8,), ("data",)), _cpu_mesh((4,), ("data",))
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    tree = {"w": place(w, NamedSharding(m8, P("data", None))),
            "step_stats": torch.tensor([3.0, 4.0])}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, tree, blocking=True)
    got = mgr.restore(7, tree, shardings={"w": NamedSharding(m4, P("data", None)),
                                          "step_stats": NamedSharding(m4, P())})
    assert torch.equal(gather(got["w"]), w) and got["w"].sharding.mesh.size == 4
    assert [tuple(s.shape) for s in got["w"].shards.flat] == [(2, 8)] * 4
    assert torch.equal(gather(got["step_stats"]), torch.tensor([3.0, 4.0]))
    again = mgr.restore(7, tree)
    assert again["w"].sharding.mesh.size == 8 and torch.equal(gather(again["w"]), w)
    with pytest.raises(ValueError, match="structure"):
        mgr.restore(7, tree, shardings={"w": NamedSharding(m4, P("data", None))})
    with pytest.raises(ValueError, match="does not divide"):
        mgr.restore(7, tree, shardings={"w": NamedSharding(_cpu_mesh((3,), ("data",)),
                                                           P("data", None)),
                                        "step_stats": None})


def test_reference_checkpoint_from_a_sharded_tree_restores_with_shardings(ref):
    """The reference saves a tree device_put on 8 coordinates (a bf16 leaf
    split by column); the port restores it onto 4 with shardings, bit for
    bit, and writes it back in the reference's format."""
    _, ckpt = ref
    want = _ckpt_tree()
    m4 = _cpu_mesh((2, 2), ("data", "model"))
    like = {"w": torch.zeros(8, 8), "e": torch.zeros(4, 8, dtype=torch.bfloat16),
            "step_stats": torch.zeros(2)}
    shardings = {"w": NamedSharding(m4, P("data", "model")),
                 "e": NamedSharding(m4, P(None, ("data", "model"))), "step_stats": None}
    got = CheckpointManager(ckpt).restore(3, like, shardings=shardings)
    assert torch.equal(gather(got["w"]), torch.from_numpy(want["w"]))
    assert torch.equal(gather(got["e"]), torch.from_numpy(want["e"]).bfloat16())
    assert got["e"].shards[0, 1].shape == (4, 2)
    assert torch.equal(got["step_stats"], torch.from_numpy(want["step_stats"]))
