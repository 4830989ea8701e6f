"""The port's single-device GNNs against the reference on the CPU: the
message-passing substrate, the fanout sampler, GIN, GraphCast, DimeNet, the
CG tables and MACE, their losses and one train step, at the smoke configs.

Weights are the reference's ``init_params`` pytree carried across by
``repro_torch.convert.gnn_params_from_numpy``; inputs are made with numpy
from a seed and fed to both packages. Tolerances: host numpy results
(``pad_edges``, ``bidirect``, ``build_triplets``, the CG tables, every
sampler array) are compared exactly; every float result within 1e-5 of
its largest entry, leaf by leaf (``_leaf_close``: max |got - want| <=
1e-5 * max |want|, so entries that cancel to float noise do not count as
relative error); one train step's parameters and moments within 1e-4 of
each leaf's largest entry (AdamW's first step moves every entry by about
lr · sign(g), so a gradient entry at float noise can flip).
Properties of the port alone (MACE's rotation and permutation invariance,
the CG identities) use the reference test's bounds."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.configs import shapes as ref_shapes  # noqa: E402
from repro.graphs import generators as ref_gen  # noqa: E402
from repro.graphs.formats import to_csr as ref_to_csr  # noqa: E402
from repro.graphs.sampler import NeighborSampler as RefSampler  # noqa: E402
from repro.models.gnn import cg as ref_cg  # noqa: E402
from repro.models.gnn import common as ref_C  # noqa: E402
from repro.models.gnn import dimenet as ref_dimenet  # noqa: E402
from repro.models.gnn import gin as ref_gin  # noqa: E402
from repro.models.gnn import graphcast as ref_graphcast  # noqa: E402
from repro.models.gnn import mace as ref_mace  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
from repro_torch.configs import get_config, get_smoke, shapes  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    gnn_params_from_numpy,
    gnn_params_into_,
    gnn_params_to_numpy,
    gnn_params_to_tree,
)
from repro_torch.graphs.sampler import NeighborSampler  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.models.gnn import cg, dimenet, gin, graphcast, mace  # noqa: E402
from repro_torch.models.gnn import common as C  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import steps  # noqa: E402

ARCHS = ["gin_tu", "graphcast", "dimenet", "mace"]
LEAF_TOL = 1e-5
STEP_LEAF_TOL = 1e-4
ROTATION_SEEDS = [0, 1, 7, 42, 123, 999, 2024, 9876]


def _leaf_close(got, want, tol=LEAF_TOL, where=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (where, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{where}: max |diff| {err:.3e} > {tol} * {scale:.3e}"


def _trees_close(got, want, tol=LEAF_TOL):
    """Leaf by leaf as ``_leaf_close``; a 0-d leaf (GIN's ε, which scales the
    whole layer input, so its gradient is a sum over every node and channel
    that cancels) by the largest entry of its layer's leaves."""
    gl = jax.tree_util.tree_flatten_with_path(got)[0]
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in gl] == [p for p, _ in wl]
    layer_max = {}
    for path, w in wl:
        key = path[:2]
        layer_max[key] = max(layer_max.get(key, 0.0), float(np.abs(np.asarray(w)).max()))
    for (path, g), (_, w) in zip(gl, wl):
        where = jax.tree_util.keystr(path)
        if np.ndim(w) == 0:
            err = abs(float(g) - float(w))
            assert err <= tol * layer_max[path[:2]], f"{where}: |diff| {err:.3e}"
        else:
            _leaf_close(g, w, tol, where)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------------------------
# inputs and weights
# --------------------------------------------------------------------------
def _toy_graph(n=20, p=0.3, seed=0, pad=7):
    g = ref_gen.gnp(n, p, seed=seed)
    edges = ref_C.bidirect(g.edges)
    return ref_C.pad_edges(edges, len(edges) + pad, n)


def _molecule(rng, n=12, radius=3.5):
    pos = rng.normal(size=(n, 3)) * 1.5
    d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    src, dst = np.nonzero((d < radius) & (d > 0))
    edges = np.stack([src, dst], axis=1).astype(np.int32)
    return rng.integers(0, 4, size=n), pos.astype(np.float32), edges


def _molecules(seed, sizes=(9, 12, 7)):
    """A batch of molecules: z, pos, phantom-padded edges, triplets (phantom
    E), graph ids with two phantom nodes (id n_graphs, dropped) and one node
    whose id n_graphs + 2 lies outside the reference's n_graphs + 1
    segments (dropped too), and the per-graph count."""
    rng = np.random.default_rng(seed)
    zs, ps, es, gids, off = [], [], [], [], 0
    for g, n in enumerate(sizes):
        z, pos, e = _molecule(rng, n)
        zs.append(z), ps.append(pos), es.append(e + off), gids.append(np.full(n, g))
        off += n
    ng = len(sizes)
    z = np.concatenate(zs + [np.array([1, 2, 3])])
    pos = np.concatenate(ps + [rng.normal(size=(3, 3)).astype(np.float32)])
    gids = np.concatenate(gids + [np.array([ng, ng, ng + 2])]).astype(np.int32)
    edges = np.concatenate(es).astype(np.int32)
    n = len(z)
    extra = np.array([[n - 1, n - 2], [n - 2, n - 1], [n - 3, 0]], np.int32)  # phantom-node edges
    edges = np.concatenate([edges, extra])
    tri = ref_dimenet.build_triplets(edges, n, max_per_edge=6)
    return {"z": z.astype(np.int32), "pos": pos, "edges": ref_C.pad_edges(edges, len(edges) + 5, n),
            "triplets": tri, "graph_ids": gids, "n_graphs": ng}


_REF_INIT = {"gin": ref_gin.init_params, "graphcast": ref_graphcast.init_params,
             "dimenet": ref_dimenet.init_params, "mace": ref_mace.init_params}


def _case(arch, seed=0, **init_kw):
    """(reference cfg, reference params, port cfg, port model) of one arch."""
    cfg = ref_get_smoke(arch)
    params = _REF_INIT[cfg.family](jax.random.PRNGKey(seed), cfg, **init_kw)
    pcfg = get_smoke(arch)
    return cfg, params, pcfg, gnn_params_from_numpy(_np_tree(params), pcfg, device="cpu")


def _gin_case(seed=0, d_in=8):
    return _case("gin_tu", seed, d_in=d_in)


def _sampled(n=200, fanouts=(5, 3, 2), seed=0, n_seeds=16):
    g = ref_gen.powerlaw(n, m_per_node=5, seed=seed)
    indptr, indices = ref_to_csr(g)
    return indptr, indices, list(fanouts), np.arange(n_seeds), g.n_nodes


def _block_dicts(mb):
    """The reference smoke test's blocks: innermost hop first."""
    return [{"src_idx": blk.src_nodes, "dst_index": blk.dst_index, "mask": blk.mask,
             "n_dst": len(blk.nodes)} for blk in reversed(mb.blocks)]


def _batch(arch, seed=0):
    """One loss batch of ``arch`` (numpy), at the smoke config."""
    rng = np.random.default_rng(seed)
    cfg = ref_get_smoke(arch)
    if arch == "graphcast":
        edges = _toy_graph(n=30, seed=seed)
        return {"x": rng.standard_normal((30, cfg.n_vars)).astype(np.float32), "edges": edges,
                "target": rng.standard_normal((30, cfg.n_vars)).astype(np.float32)}
    if arch in ("dimenet", "mace"):
        b = _molecules(seed)
        b["target"] = rng.standard_normal(b["n_graphs"]).astype(np.float32)
        if arch == "mace":
            del b["triplets"]
        return b
    raise ValueError(arch)


def _gin_batch(kind, seed=0, d_in=8):
    rng = np.random.default_rng(seed)
    if kind == "sampled":
        indptr, indices, fanouts, seeds, n = _sampled(seed=seed)
        mb = NeighborSampler(indptr, indices, fanouts, seed=seed).sample(seeds)
        return {"x": rng.standard_normal((n, d_in)).astype(np.float32),
                "blocks": _block_dicts(mb),
                "labels": rng.integers(0, 2, len(seeds)).astype(np.int32)}
    edges = _toy_graph(n=24, seed=seed)
    b = {"x": rng.standard_normal((24, d_in)).astype(np.float32), "edges": edges}
    if kind == "graphs":
        b["graph_ids"] = np.concatenate([np.repeat([0, 1, 2], 7), [3, -1, 3]]).astype(np.int32)
        b["n_graphs"] = 3
        b["labels"] = rng.integers(0, 2, 3).astype(np.int32)
    else:
        b["labels"] = rng.integers(0, 2, 24).astype(np.int32)
    return b


def _ref_batch(batch):
    """The batch as the reference takes it (jnp arrays; ints stay ints)."""
    out = {}
    for k, v in batch.items():
        if k == "blocks":
            out[k] = [{kk: (vv if kk == "n_dst" else jnp.asarray(vv)) for kk, vv in b.items()}
                      for b in v]
        elif isinstance(v, np.ndarray):
            out[k] = jnp.asarray(v)
        else:
            out[k] = v
    return out


# --------------------------------------------------------------------------
# configs, shapes, the registry
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_gnn_configs_are_copies_of_the_reference(arch):
    for port, ref in ((get_config(arch), ref_get_config(arch)),
                      (get_smoke(arch), ref_get_smoke(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_shapes_are_copies_of_the_reference():
    for name in ("LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES", "TRIANGLE_SHAPES"):
        assert ([dataclasses.asdict(s) for s in getattr(shapes, name)]
                == [dataclasses.asdict(s) for s in getattr(ref_shapes, name)])
    for arch in ARCHS + ["yi_6b", "autoint", "triangle"]:
        assert ([dataclasses.asdict(s) for s in shapes.shapes_for(arch)]
                == [dataclasses.asdict(s) for s in ref_shapes.shapes_for(arch)])


# --------------------------------------------------------------------------
# host numpy: exact
# --------------------------------------------------------------------------
def test_pad_edges_and_bidirect_are_the_references():
    e = np.random.default_rng(0).integers(0, 50, (37, 2)).astype(np.int32)
    for got, want in ((C.bidirect(e), ref_C.bidirect(e)),
                      (C.pad_edges(e, 45, 50), ref_C.pad_edges(e, 45, 50)),
                      (C.pad_edges(C.bidirect(e), 80, 50),
                       ref_C.pad_edges(ref_C.bidirect(e), 80, 50))):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,max_per_edge", [(0, 6), (1, 8), (2, 2)])
def test_build_triplets_is_the_references(seed, max_per_edge):
    b = _molecules(seed)
    got = dimenet.build_triplets(b["edges"], len(b["z"]), max_per_edge)
    want = ref_dimenet.build_triplets(b["edges"], len(b["z"]), max_per_edge)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("l1,l2,l3", ref_mace._paths(2) + [(3, 2, 4), (4, 4, 4)])
def test_cg_tables_are_the_references(l1, l2, l3):
    np.testing.assert_array_equal(cg.complex_cg(l1, l2, l3), ref_cg.complex_cg(l1, l2, l3))
    np.testing.assert_array_equal(cg.real_cg(l1, l2, l3), ref_cg.real_cg(l1, l2, l3))
    for l in (l1, l2, l3):
        np.testing.assert_array_equal(cg.real_to_complex(l), ref_cg.real_to_complex(l))


@pytest.mark.parametrize("fanouts,seed", [((5, 3, 2), 0), ((15, 10), 3), ((4,), 11)])
def test_sampler_is_the_references_bit_for_bit(fanouts, seed):
    indptr, indices, fanouts, seeds, _ = _sampled(fanouts=fanouts, seed=seed, n_seeds=24)
    ours, ref = NeighborSampler(indptr, indices, fanouts, seed=seed), RefSampler(
        indptr, indices, fanouts, seed=seed)
    for draw in range(2):  # the generator's state carries over between batches
        got, want = ours.sample(seeds + draw), ref.sample(seeds + draw)
        arrays = [(got.seed_nodes, want.seed_nodes), (got.input_nodes, want.input_nodes)]
        assert len(got.blocks) == len(want.blocks) == len(fanouts)
        for gb, wb in zip(got.blocks, want.blocks):
            arrays += [(getattr(gb, f), getattr(wb, f))
                       for f in ("nodes", "src_nodes", "mask", "dst_index")]
        for a, b in arrays:
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# the substrate: within 1e-5, gradients too
# --------------------------------------------------------------------------
def _ids_with_outsiders(rng, e, n):
    """dst ids in [0, n) with empty segments, the phantom n, and ids the
    reference drops (past n and negative)."""
    ids = rng.integers(0, n - 3, e).astype(np.int32)  # the last 3 segments stay empty
    ids[:4] = [n, n + 2, -1, n]
    return ids


@pytest.mark.parametrize("aggregator", ["sum", "mean", "max"])
def test_aggregate_and_its_gradient_match_reference(aggregator):
    rng = np.random.default_rng(1)
    n, e, d = 11, 40, 5
    msgs = rng.standard_normal((e, d)).astype(np.float32)
    msgs[7] = msgs[8]  # a tie for the max, split evenly in both
    ids = _ids_with_outsiders(rng, e, n)
    ids[8] = ids[7]
    w = rng.standard_normal((n, d)).astype(np.float32)
    want_out = ref_C.aggregate(jnp.asarray(msgs), jnp.asarray(ids), n, aggregator)
    want_g = jax.grad(lambda m: jnp.sum(ref_C.aggregate(m, jnp.asarray(ids), n, aggregator) * w))(
        jnp.asarray(msgs))
    m = _t(msgs).requires_grad_()
    out = C.aggregate(m, _t(ids), n, aggregator)
    (g,) = torch.autograd.grad(torch.sum(out * _t(w)), [m])
    _leaf_close(out.detach().numpy(), want_out, where="out")
    _leaf_close(g.numpy(), want_g, where="grad")
    if aggregator == "max":
        assert not out[n - 3:].any()  # empty segments are 0, not -inf


def test_segment_sum_drops_ids_outside_the_range_as_the_reference_does():
    rng = np.random.default_rng(2)
    data = rng.standard_normal((30, 3)).astype(np.float32)
    ids = rng.integers(-3, 9, 30).astype(np.int32)  # 0..5 in range for 6 segments
    want = jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids), num_segments=6)
    got = C.segment_sum(_t(data), _t(ids), 6)
    _leaf_close(got.numpy(), want)
    # a clamp would have added ids 6..8 into the last segment
    keep = (ids >= 0) & (ids < 6)
    np.testing.assert_allclose(got[5].numpy(), data[keep & (ids == 5)].sum(0), rtol=1e-6)


def test_gather_src_with_phantoms_and_its_gradient():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((9, 4)).astype(np.float32)
    src = np.array([0, 8, 9, 3, 9, 12, 5], np.int32)  # phantom 9, and 12 past it
    w = rng.standard_normal((7, 4)).astype(np.float32)
    want = ref_C.gather_src(jnp.asarray(x), jnp.asarray(src))
    want_g = jax.grad(lambda a: jnp.sum(ref_C.gather_src(a, jnp.asarray(src)) * w))(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    got = C.gather_src(xt, _t(src))
    (g,) = torch.autograd.grad(torch.sum(got * _t(w)), [xt])
    _leaf_close(got.detach().numpy(), want)
    _leaf_close(g.numpy(), want_g)
    assert not got[[2, 4, 5]].any()


def test_layer_norm_sh_and_the_bases_match_reference():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((6, 10)) * 3 + 1).astype(np.float32)
    _leaf_close(C.layer_norm(_t(x)).numpy(), ref_C.layer_norm(jnp.asarray(x)))
    v = rng.standard_normal((20, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    for l in range(3):
        _leaf_close(cg.sh_l(_t(v.astype(np.float32)), l).numpy(),
                    ref_cg.sh_l(jnp.asarray(v, jnp.float32), l), where=f"sh_l {l}")
        np.testing.assert_array_equal(cg.sh_l(v, l), ref_cg.sh_l(v, l))  # numpy: exact
    d = np.concatenate([rng.uniform(0.0, 6.0, 30), [0.0, 1e-9, 4.999, 5.0, 7.0]]).astype(np.float32)
    _leaf_close(dimenet.envelope(_t(d), 5.0).numpy(), ref_dimenet.envelope(jnp.asarray(d), 5.0))
    _leaf_close(dimenet.radial_basis(_t(d), 6, 5.0).numpy(),
                ref_dimenet.radial_basis(jnp.asarray(d), 6, 5.0))
    ang = rng.uniform(0, np.pi, len(d)).astype(np.float32)
    _leaf_close(dimenet.spherical_basis(_t(d), _t(ang), 7, 6, 5.0).numpy(),
                ref_dimenet.spherical_basis(jnp.asarray(d), jnp.asarray(ang), 7, 6, 5.0))
    t = rng.standard_normal((5, 8)).astype(np.float32)
    sb = rng.standard_normal((5, 3)).astype(np.float32)
    wb = rng.standard_normal((3, 8, 8)).astype(np.float32)
    _leaf_close(dimenet.bilinear_apply(_t(sb), _t(wb), _t(t)).numpy(),
                ref_dimenet.bilinear_apply(jnp.asarray(sb), jnp.asarray(wb), jnp.asarray(t)))


# --------------------------------------------------------------------------
# the models' forward passes
# --------------------------------------------------------------------------
@pytest.mark.parametrize("aggregator", ["sum", "mean", "max"])
def test_gin_logits_nodes_match_reference(aggregator):
    cfg, params, pcfg, model = _gin_case()
    cfg, pcfg = (dataclasses.replace(c, aggregator=aggregator) for c in (cfg, pcfg))
    b = _gin_batch("nodes")
    want = ref_gin.logits_nodes(params, cfg, jnp.asarray(b["x"]), jnp.asarray(b["edges"]))
    got = gin.logits_nodes(model, pcfg, _t(b["x"]), _t(b["edges"]))
    assert got.shape == (24, pcfg.n_classes)
    _leaf_close(got.numpy(), want)


def test_gin_logits_graphs_drop_graph_ids_out_of_range():
    """Graph ids n_graphs and -1 are dropped by the reference's segment sum
    over n_graphs segments; the port masks them (a clamp would add them
    into the last graph)."""
    cfg, params, pcfg, model = _gin_case(1)
    b = _gin_batch("graphs", seed=1)
    args = (b["x"], b["edges"], b["graph_ids"])
    want = ref_gin.logits_graphs(params, cfg, *map(jnp.asarray, args), b["n_graphs"])
    got = gin.logits_graphs(model, pcfg, *map(_t, args), b["n_graphs"])
    _leaf_close(got.numpy(), want)
    h = gin.forward_nodes(model, pcfg, _t(b["x"]), _t(b["edges"]))
    clamped = C.mlp_apply(model.readout, torch.zeros(3, h.shape[1]).index_add(
        0, _t(np.clip(b["graph_ids"], 0, 2)).long(), h))
    assert not torch.allclose(got, clamped)


def test_gin_forward_sampled_matches_reference():
    cfg, params, pcfg, model = _gin_case(2)
    b = _gin_batch("sampled", seed=2)
    want = ref_gin.forward_sampled(params, cfg, jnp.asarray(b["x"]),
                                   _ref_batch(b)["blocks"])
    got = gin.forward_sampled(model, pcfg, _t(b["x"]), _block_dicts_t(b["blocks"]))
    assert got.shape == (16, pcfg.n_classes)
    _leaf_close(got.numpy(), want)


def _block_dicts_t(blocks):
    return [{k: (v if k == "n_dst" else _t(v)) for k, v in blk.items()} for blk in blocks]


def test_graphcast_forward_matches_reference():
    cfg, params, pcfg, model = _case("graphcast", 3)
    b = _batch("graphcast", 3)
    want = ref_graphcast.forward(params, cfg, jnp.asarray(b["x"]), jnp.asarray(b["edges"]))
    got = graphcast.forward(model, pcfg, _t(b["x"]), _t(b["edges"]))
    _leaf_close(got.numpy(), want)
    feats = np.random.default_rng(3).standard_normal((len(b["edges"]), 4)).astype(np.float32)
    want = ref_graphcast.forward(params, cfg, jnp.asarray(b["x"]), jnp.asarray(b["edges"]),
                                 jnp.asarray(feats))
    _leaf_close(graphcast.forward(model, pcfg, _t(b["x"]), _t(b["edges"]), _t(feats)).numpy(),
                want)


_REF_ENERGY = {"dimenet": jax.jit(ref_dimenet.forward_energy, static_argnums=(1,),
                                  static_argnames=("n_graphs",)),
               "mace": jax.jit(ref_mace.forward_energy, static_argnums=(1,),
                               static_argnames=("n_graphs",))}


@pytest.mark.parametrize("arch", ["dimenet", "mace"])
@pytest.mark.parametrize("batched", [False, True])
def test_energies_match_reference(arch, batched):
    cfg, params, pcfg, model = _case(arch, 4)
    b = _batch(arch, 4)
    fwd = dimenet.forward_energy if arch == "dimenet" else mace.forward_energy
    args = ["z", "pos", "edges"] + (["triplets"] if arch == "dimenet" else [])
    kw = {"graph_ids": b["graph_ids"], "n_graphs": b["n_graphs"]} if batched else {}
    want = _REF_ENERGY[arch](params, cfg, *(jnp.asarray(b[k]) for k in args),
                             **{k: (jnp.asarray(v) if k == "graph_ids" else v)
                                for k, v in kw.items()})
    got = fwd(model, pcfg, *(_t(b[k]) for k in args),
              **{k: (_t(v) if k == "graph_ids" else v) for k, v in kw.items()})
    assert got.shape == ((b["n_graphs"],) if batched else (1,))
    _leaf_close(got.numpy(), want)


# --------------------------------------------------------------------------
# losses, gradients, one train step
# --------------------------------------------------------------------------
LOSS_CASES = ["gin_nodes", "gin_graphs", "gin_sampled", "graphcast", "dimenet", "mace"]


def _loss_case(case, seed):
    if case.startswith("gin"):
        cfg, params, pcfg, model = _gin_case(seed)
        return cfg, params, pcfg, model, _gin_batch(case[4:], seed)
    return (*_case(case, seed), _batch(case, seed))


def _jit_on_batch(fn, batch, *args):
    """``fn(*args, batch)`` jitted over ``args`` and the batch's arrays; the
    batch's ints (``n_graphs``) and its sampled blocks (their ``n_dst``)
    stay static."""
    static = {k: v for k, v in _ref_batch(batch).items() if not isinstance(v, jax.Array)}
    arrays = {k: v for k, v in _ref_batch(batch).items() if isinstance(v, jax.Array)}
    return jax.jit(lambda a, *xs: fn(*xs, {**a, **static}))(arrays, *args)


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype == np.float32
                        else a, tree)


@pytest.mark.parametrize("case", LOSS_CASES)
def test_gnn_loss_and_every_gradient_leaf_match_reference(case):
    """The loss and every gradient leaf against the reference's computed in
    float64 (the same weights and inputs, widened): the reference's own
    float32 rounding reaches 1.4e-5 of a leaf where GIN's pooled logits
    reach 137, past the tolerance."""
    cfg, params, pcfg, model, batch = _loss_case(case, 5)
    with jax.enable_x64(True):
        b64 = {k: (_f64(v) if k in ("x", "pos", "target") else v) for k, v in batch.items()}
        want, want_g = _jit_on_batch(
            lambda p, b: jax.value_and_grad(ref_steps.gnn_loss)(p, cfg, b), b64,
            _f64(_np_tree(params)))
    names = [n for n, _ in model.named_parameters()]
    ps = [p.requires_grad_() for _, p in model.named_parameters()]
    got = steps.gnn_loss(model, pcfg, batch)
    grads = torch.autograd.grad(got, ps, allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(got.item(), float(want), rtol=LEAF_TOL)
    _trees_close(gnn_params_to_numpy(dict(zip(names, grads)), pcfg), _np_tree(want_g))


@pytest.mark.parametrize("case", LOSS_CASES)
def test_one_gnn_train_step_matches_reference(case):
    """One step against the reference's in float64 (as the gradient test)."""
    cfg, params, pcfg, model, batch = _loss_case(case, 6)
    with jax.enable_x64(True):
        params = _f64(_np_tree(params))
        b64 = {k: (_f64(v) if k in ("x", "pos", "target") else v) for k, v in batch.items()}
        params, ref_state, ref_m = _jit_on_batch(ref_steps.make_gnn_train_step(cfg), b64,
                                                 params, ref_opt.init_state(params))
    state, old = opt.init_state(model), gnn_params_to_numpy(model, pcfg)
    before = launch_counts()
    out, state, m = steps.make_gnn_train_step(pcfg)(model, state, batch)
    assert out is model and launch_counts() == before  # no hand-written kernel
    assert not any(p.requires_grad for p in model.parameters())
    np.testing.assert_allclose(m["loss"].item(), float(ref_m["loss"]), rtol=LEAF_TOL)
    for k in ("m", "v"):
        _trees_close(gnn_params_to_numpy(state[k], pcfg), _np_tree(ref_state[k]))
    new = gnn_params_to_numpy(model, pcfg)
    _step_close(new, _np_tree(params), _np_tree(ref_state["m"]))
    _applies_adamw(new, old, {k: gnn_params_to_numpy(state[k], pcfg) for k in ("m", "v")})
    assert int(state["step"]) == int(ref_state["step"]) == 1


def _step_close(got, want, moment, cfg=opt.AdamWConfig(weight_decay=0.0)):
    """Parameters after one AdamW step, leaf by leaf, within 1e-5 of the
    leaf's largest entry, except where AdamW's ε makes that impossible.
    The first step moves an entry by lr · g / (|g| + ε) (g the clipped
    gradient, m / (1 - b1)), so a gradient error dg moves it by
    lr · ε · dg / (|g| + ε)². Where that, for the error the gradient check
    allows (1e-5 of the leaf's largest gradient), exceeds the tolerance,
    the entry is held to the step's bound, lr (and to the update rule by
    ``_applies_adamw``)."""
    gl = jax.tree_util.tree_flatten_with_path(got)[0]
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w), mo in zip(gl, wl, jax.tree.leaves(moment)):
        g, w, grad = (np.asarray(a, np.float64) for a in (g, w, mo))
        grad = grad / (1 - cfg.b1)
        tol = LEAF_TOL * np.abs(w).max()
        moved = cfg.lr * cfg.eps * LEAF_TOL * np.abs(grad).max() / (np.abs(grad) + cfg.eps) ** 2
        err = np.abs(g - w)
        where = jax.tree_util.keystr(path)
        held = moved <= tol
        assert (err[held] <= tol).all(), (where, err[held].max(), tol)
        assert (err[~held] <= cfg.lr * (1 + 1e-3)).all(), where


def _applies_adamw(new, old, state, cfg=opt.AdamWConfig(weight_decay=0.0)):
    """The port's parameters after its first step are old − lr · m̂ / (√v̂ + ε)
    of its own moments, leaf by leaf, to float32 rounding of the parameter
    (1e-5 of the leaf's largest entry)."""
    for n, o, m, v in zip(*(jax.tree.leaves(t) for t in (new, old, state["m"], state["v"]))):
        n, o, m, v = (np.asarray(a, np.float64) for a in (n, o, m, v))
        want = o - cfg.lr * ((m / (1 - cfg.b1)) / (np.sqrt(v / (1 - cfg.b2)) + cfg.eps))
        assert np.abs(n - want).max() <= LEAF_TOL * max(np.abs(want).max(), cfg.lr)


def test_gnn_loss_raises_on_an_unknown_family():
    _, _, pcfg, model = _gin_case()
    with pytest.raises(ValueError, match="bogus"):
        steps.gnn_loss(model, dataclasses.replace(pcfg, family="bogus"), _batch("mace"))


# --------------------------------------------------------------------------
# properties of the port alone
# --------------------------------------------------------------------------
def _random_rotation(rng) -> np.ndarray:
    a = rng.normal(size=(3, 3))
    q, r = np.linalg.qr(a)
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


def _mol(rng, n=10):
    pos = rng.normal(size=(n, 3)).astype(np.float64) * 1.4
    d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    src, dst = np.nonzero((d < 3.0) & (d > 0))
    return rng.integers(0, 4, size=n), pos, np.stack([src, dst], axis=1).astype(np.int32)


def _mace_energy(model, cfg, z, pos, edges):
    epad = _t(C.pad_edges(edges, len(edges) + 4, len(z)))
    return float(mace.forward_energy(model, cfg, _t(z), _t(pos.astype(np.float32)), epad)[0])


@pytest.mark.parametrize("seed", ROTATION_SEEDS)
def test_mace_energy_is_rotation_invariant(seed):
    """A global rotation plus translation of the positions leaves the energy
    unchanged (the reference test's bound, rtol 2e-3, atol 2e-4), for a
    fixed list of seeds."""
    rng = np.random.default_rng(seed)
    cfg = get_smoke("mace")
    z, pos, edges = _mol(rng)
    model = mace.init_params(torch.Generator().manual_seed(seed % 97), cfg, device="cpu")
    e0 = _mace_energy(model, cfg, z, pos, edges)
    pos_r = pos @ _random_rotation(rng).T + rng.normal(size=(1, 3))
    np.testing.assert_allclose(e0, _mace_energy(model, cfg, z, pos_r, edges), rtol=2e-3,
                               atol=2e-4)


def test_mace_energy_is_permutation_invariant():
    rng = np.random.default_rng(5)
    cfg = get_smoke("mace")
    z, pos, edges = _mol(rng)
    model = mace.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    perm = rng.permutation(len(z))
    inv = np.argsort(perm)
    np.testing.assert_allclose(_mace_energy(model, cfg, z, pos, edges),
                               _mace_energy(model, cfg, z[perm], pos[perm], inv[edges]),
                               rtol=1e-4)


def test_cg_identities_and_the_sh_covariance():
    for l in range(3):
        u = cg.real_to_complex(l)
        np.testing.assert_allclose(u @ u.conj().T, np.eye(2 * l + 1), atol=1e-12)
    c110 = cg.real_cg(1, 1, 0)[:, :, 0]  # 1⊗1→0: the (scaled) dot product
    np.testing.assert_allclose(c110, c110[0, 0] * np.eye(3), atol=1e-12)
    c111 = cg.real_cg(1, 1, 1)  # 1⊗1→1: the cross product
    np.testing.assert_allclose(c111, -np.transpose(c111, (1, 0, 2)), atol=1e-12)
    rng = np.random.default_rng(2)
    v = rng.normal(size=(6, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    rot = _random_rotation(rng)
    p = np.array([[0, 1, 0], [0, 0, 1], [1, 0, 0]], dtype=float)  # (y,z,x) <- (x,y,z)
    want = cg.sh_l(_t(v), 1).numpy() @ (p @ rot @ p.T).T
    np.testing.assert_allclose(cg.sh_l(_t(v @ rot.T), 1).numpy(), want, atol=1e-10)


def test_cg_contract_keeps_the_zero_fallback():
    """An output component with no nonzero CG entry is zeros of (N, C)."""
    x = torch.randn(4, 5, 6, generator=torch.Generator().manual_seed(0))
    y = torch.randn(4, 5, generator=torch.Generator().manual_seed(1))
    for l1, l2, l3 in mace._paths(2):
        got = mace._cg_contract(x[:, : 2 * l1 + 1], y[:, : 2 * l2 + 1], l1, l2, l3)
        assert got.shape == (4, 2 * l3 + 1, 6)
        want = ref_mace._cg_contract(jnp.asarray(x[:, : 2 * l1 + 1].numpy()),
                                     jnp.asarray(y[:, : 2 * l2 + 1].numpy()), l1, l2, l3)
        _leaf_close(got.numpy(), want, where=str((l1, l2, l3)))


# --------------------------------------------------------------------------
# weights: convert, init, devices
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_gnn_params_round_trip_and_refuse_bad_trees(arch):
    cfg, params, pcfg, model = _case(arch, 7, **({"d_in": 8} if arch == "gin_tu" else {}))
    tree = _np_tree(params)
    back = gnn_params_to_numpy(model, pcfg)
    _trees_close(back, tree, 0.0)
    twice = gnn_params_to_numpy(gnn_params_from_numpy(back, pcfg, device="cpu"), pcfg)
    _trees_close(twice, tree, 0.0)
    assert all(t.device.type == "cpu" for t in jax.tree.leaves(
        gnn_params_to_tree(model, pcfg), is_leaf=lambda x: isinstance(x, torch.Tensor)))
    stack = "blocks" if pcfg.family == "dimenet" else "layers"
    missing = jax.tree.map(lambda a: a, tree)
    missing[stack][0].pop(sorted(missing[stack][0])[0])
    with pytest.raises(KeyError, match="no leaf"):
        gnn_params_into_(model, missing, pcfg)
    short = dict(tree, **{stack: tree[stack][:-1]})
    with pytest.raises(ValueError, match=stack):
        gnn_params_into_(model, short, pcfg)
    bad = jax.tree.map(lambda a: a, tree)
    first = sorted(bad[stack][0])[0]
    leaf = bad[stack][0][first]
    bad[stack][0][first] = (np.zeros(np.shape(leaf) + (2,), np.float32) if not isinstance(
        leaf, dict) else leaf)
    if not isinstance(leaf, dict):
        with pytest.raises(ValueError, match="shape"):
            gnn_params_into_(model, bad, pcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_have_the_references_tree_and_scales(arch):
    cfg, params, pcfg, _ = _case(arch, 8, **({"d_in": 8} if arch == "gin_tu" else {}))
    make = {"gin": gin.init_params, "graphcast": graphcast.init_params,
            "dimenet": dimenet.init_params, "mace": mace.init_params}[pcfg.family]
    model = make(torch.Generator().manual_seed(8), pcfg,
                 **({"d_in": 8} if arch == "gin_tu" else {}), device="cpu")
    got = jax.tree_util.tree_flatten_with_path(gnn_params_to_numpy(model, pcfg))[0]
    want = jax.tree_util.tree_flatten_with_path(_np_tree(params))[0]
    assert [(p, np.shape(a)) for p, a in got] == [(p, np.shape(a)) for p, a in want]
    for (path, g), (_, w) in zip(got, want):
        if np.size(w) >= 64:  # each leaf drawn at the reference's scale
            assert abs(float(np.std(g)) - float(np.std(w))) <= 0.35 * float(np.std(w)) + 1e-12, \
                jax.tree_util.keystr(path)
        elif not np.any(w):
            assert not np.any(g), jax.tree_util.keystr(path)  # biases and ε start at 0


def test_gnn_models_need_a_card_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch, make in (("gin_tu", lambda c: gin.GIN(c, 8)),
                       ("graphcast", lambda c: graphcast.GraphCast(c)),
                       ("dimenet", lambda c: dimenet.DimeNet(c)),
                       ("mace", lambda c: mace.MACE(c))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(get_smoke(arch))
    assert gin.GIN(get_smoke("gin_tu"), 8, device="cpu").device.type == "cpu"
