"""The port's partitioned GNN engine (``repro_torch.models.gnn.distributed``)
on a CPU ``RingMesh`` against the reference's own distributed losses and
against the port's single-device models.

The reference runs on a mesh this file builds with Auto axes,
``jax.make_mesh((S,), ("stage",), axis_types=(AxisType.Auto,))``: the
Explicit axes ``jax.make_mesh`` gives by default in this JAX are refused by
the reference's ``with_sharding_constraint`` (ROADMAP.md §C), which is why
``tests/test_gnn_distributed.py`` fails here. Each of S = 1 and S = 4 runs
in a subprocess (S = 4 with 4 forced host devices), which writes the
reference's values to a file (:func:`dump_reference`); both start with the
first test that needs one and run side by side. Weights are the
reference's ``init_params`` carried across by
``convert.gnn_params_from_numpy``; inputs are numpy from a seed, on the
reference test's graph (``gnp(64, 0.2, seed=1)`` both ways).

Tolerances:
- losses at the reference test's bounds: GIN rtol 2e-5; GraphCast, MACE
  and DimeNet rtol 2e-4, atol 1e-5;
- every gradient leaf within 1e-5 of the leaf's largest entry (a 0-d
  leaf, GIN's ε, by the largest entry of any leaf), against the reference
  computed in float64 on the same weights and inputs widened (its own
  float32 gradients part from float64 by 2e-5 of a leaf at MACE's energies
  of ~1e5, as ``tests/test_torch_gnn.py`` found for GIN's pooled logits);
- bf16 (``compute_dtype``, GraphCast and MACE): every matrix product in
  the loss on bf16 operands; the loss relative to the reference's bf16
  loss within 2e-2 (GraphCast) and 0.2 (MACE); and the port's
  bf16-to-float32 gap on the same weights and batch at least a tenth of
  the reference's own (a float32 path gives 0). Where a bf16 value is
  rounded decides the result, and so the gap: XLA keeps a fused chain of
  bf16 ops in float32, eager PyTorch rounds after every op. At S = 1
  GraphCast's gap is 0.0017 in the port against the reference's 0.0050;
  MACE's loss is the square of an energy built from products of three
  bf16 factors, and the reference's own bf16 loss is 1222040.6 jitted and
  1154717.1 op by op, against 1265461.25 in float32, and the port's
  1369124.0;
- MACE's gradients against the float64 reference are taken in float64
  (``compute_dtype``, the same code), its float32 gradients against the
  single-device model's;
- one train step's parameters and moments as ``tests/test_torch_gnn.py``'s
  step test: 1e-5 of a leaf's largest entry, an entry whose gradient sits
  near AdamW's ε held to the step's bound lr.
- host numpy (``partition_edges_by_dst``, the triplets kept) exactly.
"""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.graphs import generators as ref_gen  # noqa: E402
from repro.models.gnn import common as ref_C  # noqa: E402
from repro.models.gnn import dimenet as ref_dimenet  # noqa: E402
from repro.models.gnn import distributed as ref_D  # noqa: E402
from repro.models.gnn import gin as ref_gin  # noqa: E402
from repro.models.gnn import graphcast as ref_graphcast  # noqa: E402
from repro.models.gnn import mace as ref_mace  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import gnn_params_from_numpy, gnn_params_to_numpy  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.launch import make_ring_mesh  # noqa: E402
from repro_torch.models.gnn import common as C  # noqa: E402
from repro_torch.models.gnn import distributed as D  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.utils import MatmulDtypes  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
N = 64
ARCHS = ["gin_tu", "graphcast", "mace", "dimenet"]
LOSS_RTOL = {"gin": dict(rtol=2e-5), "graphcast": dict(rtol=2e-4, atol=1e-5),
             "mace": dict(rtol=2e-4, atol=1e-5), "dimenet": dict(rtol=2e-4, atol=1e-5)}
LEAF_TOL = 1e-5
BF16_RTOL = {"graphcast": 2e-2, "mace": 0.2}
BF16_GAP_SHARE = 0.1
STEP_ARCH = "gin_tu"
_SEEDS = {"gin_tu": 1, "graphcast": 2, "mace": 4, "dimenet": 5}
_REF_INIT = {"gin": lambda k, cfg: ref_gin.init_params(k, cfg, d_in=8),
             "graphcast": ref_graphcast.init_params, "mace": ref_mace.init_params,
             "dimenet": ref_dimenet.init_params}
_REF_LOSS = {"gin": ref_D.gin_distributed_loss, "graphcast": ref_D.graphcast_distributed_loss,
             "mace": ref_D.mace_distributed_loss, "dimenet": ref_D.dimenet_distributed_loss}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's small tensors: the suite runs
    several workers at once, and torch's default of a thread per core
    oversubscribes the host (a MACE case took 245 s that way, 1 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# inputs, weights, and the reference's values
# --------------------------------------------------------------------------
def _edges():
    """The reference test's graph: gnp(64, 0.2, seed=1), both ways."""
    return ref_C.bidirect(ref_gen.gnp(N, 0.2, seed=1).edges)


def _ref_case(arch):
    cfg = ref_get_smoke(arch)
    return cfg, _REF_INIT[cfg.family](jax.random.PRNGKey(_SEEDS[arch]), cfg)


def _batch(arch, n_stages):
    """``arch``'s batch (numpy, global arrays) with edges partitioned over
    ``n_stages``; DimeNet's triplets are built on the partitioned edges."""
    rng = np.random.default_rng(_SEEDS[arch])
    cfg = ref_get_smoke(arch)
    edges, _ = ref_D.partition_edges_by_dst(_edges(), N, n_stages)
    if cfg.family == "gin":
        return {"x": rng.standard_normal((N, 8)).astype(np.float32), "edges": edges,
                "labels": rng.integers(0, cfg.n_classes, N).astype(np.int32)}
    if cfg.family == "graphcast":
        return {"x": rng.standard_normal((N, cfg.n_vars)).astype(np.float32), "edges": edges,
                "target": rng.standard_normal((N, cfg.n_vars)).astype(np.float32)}
    b = {"z": rng.integers(0, 4, N).astype(np.int32),
         "pos": (rng.normal(size=(N, 3)) * 2.0).astype(np.float32), "edges": edges,
         "target": np.array([0.5], np.float32)}
    if cfg.family == "dimenet":
        b["triplets"] = ref_dimenet.build_triplets(edges, N)
    return b


def _auto_mesh(n_stages):
    return jax.make_mesh((n_stages,), ("stage",),
                         axis_types=(jax.sharding.AxisType.Auto,))


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64)
                        if jnp.asarray(a).dtype == jnp.float32 else jnp.asarray(a), tree)


def reference_values(n_stages) -> dict:
    """The reference's distributed losses and gradients at ``n_stages``, every
    family computed in float64 from the same weights and inputs widened
    (at MACE's energies of ~1e5 the reference's own float32 gradients part
    from float64 by 2e-5 of a leaf); GraphCast's and MACE's bf16 losses as
    the reference computes them; and its parameters and moments after one
    GIN train step, in float64 too. A flat dict of numpy arrays (a tree's
    leaves in ``jax.tree.leaves`` order)."""
    mesh, out = _auto_mesh(n_stages), {}
    for arch in ARCHS:
        cfg, params = _ref_case(arch)
        batch = _batch(arch, n_stages)
        loss = _REF_LOSS[cfg.family](params, cfg, mesh)
        with jax.enable_x64(True):
            val, grads = jax.jit(jax.value_and_grad(lambda p, b: loss(p, b)))(
                _f64(params), _f64(batch))
            out[f"{arch}/loss"] = np.asarray(val)
            for i, leaf in enumerate(jax.tree.leaves(grads)):
                out[f"{arch}/grad/{i}"] = np.asarray(leaf)
        if cfg.family in ("graphcast", "mace"):
            bf = _REF_LOSS[cfg.family](params, cfg, mesh, compute_dtype=jnp.bfloat16)
            val = jax.jit(lambda p, b: bf(p, b))(params, jax.tree.map(jnp.asarray, batch))
            out[f"{arch}/bf16_loss"] = np.asarray(val, np.float32)
    cfg, params = _ref_case(STEP_ARCH)
    step = ref_D.make_distributed_gnn_train_step(cfg, mesh)
    with jax.enable_x64(True):
        params = _f64(params)
        params, state, m = jax.jit(step)(params, ref_opt.init_state(params),
                                         _f64(_batch(STEP_ARCH, n_stages)))
        out["step/loss"] = np.asarray(m["loss"])
        for name, tree in (("params", params), ("m", state["m"]), ("v", state["v"])):
            for i, leaf in enumerate(jax.tree.leaves(tree)):
                out[f"step/{name}/{i}"] = np.asarray(leaf)
    return out


def dump_reference(n_stages: int, path: str) -> None:
    """Entry point of a subprocess: :func:`reference_values` to ``path``."""
    assert jax.device_count() >= n_stages, jax.devices()
    np.savez(path, **reference_values(n_stages))


def _leaves(out, prefix):
    n = sum(k.startswith(prefix + "/") for k in out)
    return [out[f"{prefix}/{i}"] for i in range(n)]


def _start_reference(n_stages, tmp_path_factory):
    """A subprocess running :func:`dump_reference` with ``n_stages`` forced
    host devices; returns (the process, the file it writes)."""
    path = str(tmp_path_factory.mktemp(f"ref_s{n_stages}") / "ref.npz")
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={n_stages}",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(HERE, "..", "src"), HERE]))
    code = ("import test_torch_gnn_distributed as t\n"
            f"t.dump_reference({n_stages}, {path!r})\n")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env, cwd=HERE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, path


@pytest.fixture(scope="module")
def _reference_runs(tmp_path_factory):
    """The reference's runs at S = 1 and S = 4, one subprocess each, both
    started by the first test that needs a reference value and run side by
    side; a test that needs none (the partition, the layout, the
    single-device comparisons) starts neither."""
    runs = {s: _start_reference(s, tmp_path_factory) for s in (1, 4)}
    yield runs
    for proc, _ in runs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _read_reference(run) -> dict:
    proc, path = run
    try:
        _, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, err[-4000:]
    with np.load(path) as f:
        return dict(f)


@pytest.fixture(scope="module")
def ref_s1(_reference_runs):
    return _read_reference(_reference_runs[1])


@pytest.fixture(scope="module")
def ref_s4(_reference_runs):
    return _read_reference(_reference_runs[4])


def _refs(n_stages, request):
    return request.getfixturevalue("ref_s1" if n_stages == 1 else "ref_s4")


# --------------------------------------------------------------------------
# the port
# --------------------------------------------------------------------------
def _model(arch):
    cfg, params = _ref_case(arch)
    pcfg = get_smoke(arch)
    return pcfg, gnn_params_from_numpy(jax.tree.map(np.asarray, params), pcfg, device="cpu")


def _cpu_mesh(n_stages):
    return make_ring_mesh(n_stages, devices=["cpu"] * n_stages)


def _loss_and_grads(loss_fn, model, pcfg, batch):
    """(loss, the gradient as the reference's tree) of ``loss_fn(model)``."""
    named = dict(model.named_parameters())
    model.requires_grad_(True)
    try:
        loss = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                    materialize_grads=True)
    finally:
        model.requires_grad_(False)
    return loss.detach(), gnn_params_to_numpy(dict(zip(named, grads)), pcfg)


def _leaves_close(got, want, tol=LEAF_TOL, what=""):
    """Leaf by leaf within ``tol`` of the leaf's largest entry; a 0-d leaf
    (GIN's ε: its gradient is a sum over every node and channel that
    cancels) by the largest entry of any leaf."""
    got, want = jax.tree.leaves(got), list(want)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        scale = np.abs(w).max() if w.ndim else max(np.abs(np.asarray(x)).max() for x in want)
        err = float(np.abs(g - w).max())
        assert err <= tol * max(scale, 1e-30), f"{what} leaf {i}: {err:.3e} > {tol} * {scale:.3e}"


# --------------------------------------------------------------------------
# the partition
# --------------------------------------------------------------------------
def _partition_cases():
    g = ref_gen.gnp(64, 0.3, seed=0)  # tests/test_graph_substrate.py's case
    edges = ref_C.bidirect(g.edges)
    phantoms = np.concatenate([edges, np.full((5, 2), 64, np.int32), [[3, 70], [70, 3]]])
    return [(edges, 64, 8), (_edges(), N, 1), (_edges(), N, 2), (_edges(), N, 4),
            (_edges(), N, 8), (phantoms, 64, 4), (_edges(), 70, 3),
            (np.zeros((0, 2), np.int32), 16, 4)]


@pytest.mark.parametrize("case", range(8))
def test_partition_edges_by_dst_equals_reference(case):
    edges, n_pad, n_dev = _partition_cases()[case]
    want, want_loc = ref_D.partition_edges_by_dst(edges, n_pad, n_dev)
    got, got_loc = D.partition_edges_by_dst(edges, n_pad, n_dev)
    assert got_loc == want_loc and got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_rows_that_do_not_split_over_the_mesh_raise():
    pcfg, model = _model("gin_tu")
    batch = _batch("gin_tu", 3)
    with pytest.raises(ValueError, match="divisible"):
        D.gin_distributed_loss(model, pcfg, _cpu_mesh(3))(model, batch)


def test_stages_that_share_a_device_read_one_gathered_tensor():
    mesh = _cpu_mesh(4)
    shards = D.row_shards(torch.arange(8.0)[:, None], mesh)
    full = D.replicate_rows(shards, mesh)
    assert all(t is full[0] for t in full)
    assert torch.equal(full[0][:, 0], torch.arange(8.0))
    assert D.replicate_rows(shards[:1], _cpu_mesh(1))[0] is shards[0]


def test_mlp_apply_takes_a_module_or_its_tensors_by_leaf_name():
    """The single-device models pass ``common.mlp_apply`` a ``DenseMLP``;
    the partitioned engine passes each device's (cast) tensors by leaf
    name: one arithmetic, the same result."""
    pcfg, model = _model("gin_tu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((5, 8)).astype(np.float32))
    mlp = model.layers[0].mlp
    for kw in ({}, {"act": torch.relu, "final_act": True}):
        want = C.mlp_apply(mlp, x, **kw)
        got = C.mlp_apply(D._sub(D._weights(model, _cpu_mesh(1))[torch.device("cpu")],
                                 "layers.0.mlp"), x, **kw)
        assert torch.equal(got, want)


def test_matmul_dtypes_records_every_products_operands():
    a, b = torch.ones(2, 3), torch.ones(3, 4)
    with MatmulDtypes() as mm:
        a @ b
        torch.matmul(a.double(), b.double())
        a.bfloat16().matmul(b.bfloat16())
        a + 1.0
    assert mm.seen == [(torch.float32,) * 2, (torch.float64,) * 2, (torch.bfloat16,) * 2]


# --------------------------------------------------------------------------
# against the reference's distributed losses
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_stages", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_distributed_loss_and_gradients_match_reference(arch, n_stages, request):
    """MACE's gradients are taken with ``compute_dtype=torch.float64``: at its
    energies of ~1e3 from site energies of ~1e2 the port's float32 gradients
    part from float64 by 1.7e-5 of a leaf, as the reference's own float32
    ones do (2e-5); its float32 gradients are held to the single-device
    model's below."""
    ref = _refs(n_stages, request)
    pcfg, model = _model(arch)
    batch, mesh = _batch(arch, n_stages), _cpu_mesh(n_stages)
    builder = D._BUILDERS[pcfg.family]
    before = launch_counts()
    loss, grads = _loss_and_grads(builder(model, pcfg, mesh), model, pcfg, batch)
    assert launch_counts() == before  # no hand-written kernel on this path
    np.testing.assert_allclose(float(loss), float(ref[f"{arch}/loss"]),
                               **LOSS_RTOL[pcfg.family])
    if pcfg.family == "mace":
        _, grads = _loss_and_grads(builder(model, pcfg, mesh, compute_dtype=torch.float64),
                                   model, pcfg, batch)
    _leaves_close(grads, _leaves(ref, f"{arch}/grad"), what=f"{arch} S={n_stages}")


@pytest.mark.parametrize("n_stages", [1, 4])
@pytest.mark.parametrize("arch", ["graphcast", "mace"])
def test_bf16_distributed_loss_matches_reference(arch, n_stages, request):
    """Every matrix product of the bf16 loss takes bf16 operands, the loss
    lies within ``BF16_RTOL`` of the reference's bf16 loss, and it parts
    from the port's float32 loss on the same weights and batch by at least
    ``BF16_GAP_SHARE`` of the reference's own bf16-to-float32 gap: a port
    that ignored ``compute_dtype`` would give that gap as 0."""
    ref = _refs(n_stages, request)
    pcfg, model = _model(arch)
    builder = D._BUILDERS[pcfg.family]
    batch, mesh = _batch(arch, n_stages), _cpu_mesh(n_stages)
    with MatmulDtypes() as mm:
        loss, grads = _loss_and_grads(builder(model, pcfg, mesh, compute_dtype=torch.bfloat16),
                                      model, pcfg, batch)
    assert mm.seen and set(mm.seen) == {(torch.bfloat16, torch.bfloat16)}
    assert loss.dtype == torch.float32
    assert all(np.isfinite(g).all() and g.dtype == np.float32 for g in jax.tree.leaves(grads))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    np.testing.assert_allclose(float(loss), float(ref[f"{arch}/bf16_loss"]),
                               rtol=BF16_RTOL[pcfg.family])
    with torch.no_grad():
        f32 = float(builder(model, pcfg, mesh)(model, batch))
    ref_gap = abs(float(ref[f"{arch}/bf16_loss"]) - float(ref[f"{arch}/loss"]))
    assert abs(float(loss) - f32) >= BF16_GAP_SHARE * ref_gap > 0


def test_dimenet_keeps_the_references_in_shard_triplets_only(request):
    """At S = 4 the reference keeps a triplet only where both its edges lie
    in its own shard's slot range; most do not (ROADMAP.md §C). The port
    keeps exactly those, and its loss is the reference's (pinned beside
    it by the loss test), far from the single-device model's."""
    ref = _refs(4, request)
    batch = _batch("dimenet", 4)
    edges, trip = batch["edges"], batch["triplets"]
    e_loc = len(edges) // 4
    # the reference's rule (distributed.py, dimenet_distributed_loss), in numpy
    t = trip.reshape(4, -1, 2) - (np.arange(4) * e_loc)[:, None, None]
    want = ((t >= 0) & (t < e_loc)).all(-1)
    got = D.in_shard_triplets(trip, _cpu_mesh(4), e_loc)
    np.testing.assert_array_equal(np.stack([m.numpy() for _, _, m in got]), want)
    real = int((trip[:, 0] < len(edges)).sum())
    assert 0 < int(want.sum()) < real / 2
    pcfg, model = _model("dimenet")
    loss = D.dimenet_distributed_loss(model, pcfg, _cpu_mesh(4))(model, batch)
    np.testing.assert_allclose(float(loss), float(ref["dimenet/loss"]), rtol=2e-4, atol=1e-5)
    plain = steps.gnn_loss(model, pcfg, batch)
    assert abs(float(plain) - float(loss)) > 0.5 * abs(float(plain))


def test_one_distributed_train_step_matches_reference(ref_s4):
    pcfg, model = _model(STEP_ARCH)
    state = opt.init_state(model)
    step = D.make_distributed_gnn_train_step(pcfg, _cpu_mesh(4))
    out, state, m = step(model, state, _batch(STEP_ARCH, 4))
    assert out is model and not any(p.requires_grad for p in model.parameters())
    np.testing.assert_allclose(m["loss"].item(), float(ref_s4["step/loss"]), rtol=2e-5)
    for k in ("m", "v"):
        _leaves_close(gnn_params_to_numpy(state[k], pcfg), _leaves(ref_s4, f"step/{k}"),
                      what=k)
    lr, eps = opt.AdamWConfig().lr, opt.AdamWConfig().eps
    got = jax.tree.leaves(gnn_params_to_numpy(model, pcfg))
    grads = [np.asarray(g, np.float64) / (1 - opt.AdamWConfig().b1)
             for g in _leaves(ref_s4, "step/m")]
    for g, w, grad in zip(got, _leaves(ref_s4, "step/params"), grads):
        # tests/test_torch_gnn.py's _step_close: an entry whose gradient sits
        # near ε may move anywhere in ±lr
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        tol = LEAF_TOL * np.abs(w).max()
        moved = lr * eps * LEAF_TOL * np.abs(grad).max() / (np.abs(grad) + eps) ** 2
        held = moved <= tol
        assert (np.abs(g - w)[held] <= tol).all()
        assert (np.abs(g - w)[~held] <= lr * (1 + 1e-3)).all()
    assert int(state["step"]) == 1


# --------------------------------------------------------------------------
# against the port's single-device models
# --------------------------------------------------------------------------
def _plain_batch(arch, batch):
    """The same inputs with the unpartitioned edges, as the single-device
    models take them (DimeNet: the partitioned edges and their triplets)."""
    if arch == "dimenet":
        return batch
    return {**batch, "edges": ref_C.pad_edges(_edges(), len(_edges()) + 8, N)}


@pytest.mark.parametrize("arch,n_stages", [(a, s) for a in ("gin_tu", "graphcast", "mace")
                                           for s in (2, 4, 8)] + [("dimenet", 1)])
def test_distributed_equals_the_single_device_model(arch, n_stages):
    pcfg, model = _model(arch)
    batch = _batch(arch, n_stages)
    loss_fn = D._BUILDERS[pcfg.family](model, pcfg, _cpu_mesh(n_stages))
    loss, grads = _loss_and_grads(loss_fn, model, pcfg, batch)
    want, want_g = _loss_and_grads(lambda m, b: steps.gnn_loss(m, pcfg, b), model, pcfg,
                                   _plain_batch(arch, batch))
    np.testing.assert_allclose(float(loss), float(want), **LOSS_RTOL[pcfg.family])
    _leaves_close(grads, jax.tree.leaves(want_g), what=f"{arch} S={n_stages}")


def test_graphcast_without_remat_and_mace_in_one_chunk_give_the_same_loss():
    pcfg, model = _model("graphcast")
    batch, mesh = _batch("graphcast", 4), _cpu_mesh(4)
    with torch.no_grad():
        a = D.graphcast_distributed_loss(model, pcfg, mesh)(model, batch)
        b = D.graphcast_distributed_loss(model, pcfg, mesh, remat=False)(model, batch)
    assert torch.equal(a, b)
    pcfg, model = _model("mace")
    batch = _batch("mace", 4)
    with torch.no_grad():
        loss = D.mace_distributed_loss(model, pcfg, mesh)
        np.testing.assert_allclose(float(loss(model, batch, n_chunks=1)),
                                   float(loss(model, batch)), rtol=1e-5)
