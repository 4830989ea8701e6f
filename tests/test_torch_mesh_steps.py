"""The port's LM train and prefill steps on a ``("data", "model")`` mesh
against the reference's own mesh steps, and the partitioned GNN engine on a
flattened 2-D mesh.

The reference runs in a subprocess with 8 forced host devices on meshes
built with Auto axes (ROADMAP.md §C), jitting ``make_lm_train_step(cfg,
mesh=, seq_parallel=True, grad_specs=lm_param_specs(...))`` and
``make_lm_prefill(cfg, s_max, mesh=, seq_parallel=True)`` for the yi_6b
and deepseek_v2_lite_16b smoke configs; it writes its values to a file
(:func:`dump_reference`). On an MoE config the mesh routes the MoE through
``moe_apply_ep`` at its default capacity, so tokens drop and the mesh
loss differs from the plain step's: the port's mesh step is held to the
reference's mesh step. The port runs every coordinate on the CPU.

Tolerances, as ``tests/test_torch_train.py``'s: the loss within rtol 1e-5;
every parameter and moment leaf after one step within 1e-4 of its largest
entry; prefill logits and cache leaves within 1e-5 of their largest entry.
The layout hints (``seq_parallel``, ``grad_specs``) change no value: with
and without them the port's step is bit for bit the same.
"""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import test_torch_gnn_distributed as gnn_t  # noqa: E402
from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.launch import sharding as ref_shr  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    lm_param_shapes,
    lm_params_from_numpy,
    lm_params_to_numpy,
)
from repro_torch.launch import (  # noqa: E402
    Mesh,
    P,
    lm_param_specs,
    make_local_mesh,
    make_ring_mesh,
)
from repro_torch.models.gnn import distributed as D  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import steps  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ARCHS = ["yi_6b", "deepseek_v2_lite_16b"]
MOE_ARCH = "deepseek_v2_lite_16b"
MESH = (2, 4)
OTHER_MESHES = [(4, 2), (1, 4)]
B, S, S_MAX, CHUNK_Q = 2, 16, 20, 8
LOSS_RTOL = 1e-5
STEP_LEAF_TOL = 1e-4
LOGIT_TOL = 1e-5


def _auto_mesh(data, model):
    devs = np.asarray(jax.devices()[:data * model]).reshape(data, model)
    return jax.sharding.Mesh(devs, ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)


_ref_init = jax.jit(ref_tf.init_params, static_argnums=(1,))


def _params(arch):
    return _ref_init(jax.random.PRNGKey(0), ref_get_smoke(arch))


def _batch(arch):
    rng = np.random.default_rng(3)
    v = ref_get_smoke(arch).vocab
    return {"tokens": rng.integers(0, v, (B, S)).astype(np.int32),
            "labels": rng.integers(0, v, (B, S)).astype(np.int32)}


def reference_values() -> dict:
    """The reference's mesh train step (loss, parameters and moments after
    it) and mesh prefill (logits, cache) at (2, 4) for both configs, and the
    MoE config's loss and logits at (4, 2) and (1, 4)."""
    out = {}
    for arch in ARCHS:
        cfg, params, batch = ref_get_smoke(arch), _params(arch), _batch(arch)
        meshes = [MESH] + (OTHER_MESHES if arch == MOE_ARCH else [])
        for shape in meshes:
            mesh, key = _auto_mesh(*shape), f"{arch}/{shape[0]}x{shape[1]}"
            specs = ref_shr.lm_param_specs(jax.eval_shape(lambda: params), mesh)
            step = jax.jit(ref_steps.make_lm_train_step(
                cfg, chunk_q=CHUNK_Q, mesh=mesh, seq_parallel=True, grad_specs=specs))
            new, state, m = step(params, ref_opt.init_state(params), batch)
            out[f"{key}/loss"] = np.asarray(m["loss"])
            logits, cache = jax.jit(ref_steps.make_lm_prefill(
                cfg, S_MAX, chunk_q=CHUNK_Q, mesh=mesh, seq_parallel=True))(
                params, batch["tokens"])
            out[f"{key}/logits"] = np.asarray(logits)
            if shape != MESH:
                continue
            for name, tree in (("params", new), ("m", state["m"]), ("v", state["v"]),
                               ("cache", cache)):
                for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
                    out[f"{key}/{name}/{jax.tree_util.keystr(path)}"] = np.asarray(leaf)
    return out


def dump_reference(path: str) -> None:
    """Entry point of the subprocess: :func:`reference_values` to ``path``."""
    assert jax.device_count() >= 8, jax.devices()
    np.savez(path, **reference_values())


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors, as
    ``tests/test_torch_gnn_distributed.py`` runs them: the suite's other
    workers share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's values, from a subprocess the first test that needs
    one starts (a test that needs none starts nothing)."""
    path = str(tmp_path_factory.mktemp("mesh_steps_ref") / "ref.npz")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(HERE, "..", "src"), HERE]))
    code = f"import test_torch_mesh_steps as t\nt.dump_reference({path!r})\n"
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=HERE, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    with np.load(path) as f:
        return dict(f)


@pytest.fixture(scope="module")
def ref_params():
    return {arch: jax.tree.map(np.asarray, _params(arch)) for arch in ARCHS}


def _model(ref_params, arch):
    return lm_params_from_numpy(ref_params[arch], get_smoke(arch), device="cpu")


def _mesh(data, model):
    return make_local_mesh(data=data, model=model, devices=["cpu"] * (data * model))


def _leaf_close(got, want, tol, where):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (where, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{where}: max |diff| {err:.3e} > {tol} * {scale:.3e}"


def _tree_close(got, ref, prefix, tol):
    flat = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    want = {k[len(prefix) + 1:]: v for k, v in ref.items() if k.startswith(prefix + "/")}
    assert sorted(flat) == sorted(want), prefix
    for k, v in want.items():
        _leaf_close(flat[k], v, tol, f"{prefix}/{k}")


def _mesh_step(model, arch, mesh, **kw):
    pcfg = get_smoke(arch)
    state = opt.init_state(dict(model.named_parameters()))
    _, state, m = steps.make_lm_train_step(pcfg, chunk_q=CHUNK_Q, mesh=mesh, **kw)(
        model, state, _batch(arch))
    return m["loss"], state


def _hints(model, arch, mesh):
    return dict(seq_parallel=True,
                grad_specs=lm_param_specs(lm_param_shapes(model, get_smoke(arch)), mesh))


@pytest.mark.parametrize("arch", ARCHS)
def test_layout_hints_change_no_value(ref_params, arch):
    """seq_parallel and grad_specs are checks here (ROADMAP.md §C): the
    step with them equals the step without them bit for bit (loss,
    parameters, moments), and so does the prefill."""
    pcfg, mesh = get_smoke(arch), _mesh(*MESH)
    a, b = _model(ref_params, arch), _model(ref_params, arch)
    la, sa = _mesh_step(a, arch, mesh, **_hints(a, arch, mesh))
    lb, sb = _mesh_step(b, arch, mesh)
    assert torch.equal(la, lb)
    for (name, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(sa["m"][name], sb["m"][name]) and torch.equal(sa["v"][name],
                                                                           sb["v"][name])
    tokens = _batch(arch)["tokens"]
    pa = steps.make_lm_prefill(pcfg, S_MAX, chunk_q=CHUNK_Q, mesh=mesh, seq_parallel=True)(
        _model(ref_params, arch), tokens)
    pb = steps.make_lm_prefill(pcfg, S_MAX, chunk_q=CHUNK_Q, mesh=mesh)(
        _model(ref_params, arch), tokens)
    assert torch.equal(pa[0], pb[0])


def test_bad_specs_and_meshes_raise(ref_params):
    """What the reference refuses at trace time: a spec tree of another
    structure, an axis the mesh lacks, a spec longer than its array; and
    sequence parallelism on a mesh without a 'model' axis."""
    arch = MOE_ARCH
    pcfg, mesh = get_smoke(arch), _mesh(*MESH)
    model = _model(ref_params, arch)
    good = _hints(model, arch, mesh)["grad_specs"]
    before = {k: p.clone() for k, p in model.named_parameters()}
    for bad, match in (({k: v for k, v in good.items() if k != "unembed"}, "does not match"),
                       ({**good, "embed": P("pod", None)}, "not in the mesh"),
                       ({**good, "final_norm": P(None, None)}, "entries")):
        with pytest.raises(ValueError, match=match):
            _mesh_step(model, arch, mesh, grad_specs=bad)
    assert all(torch.equal(p, before[k]) for k, p in model.named_parameters())
    with pytest.raises(ValueError, match="not in the mesh"):
        steps.make_lm_train_step(pcfg, mesh=Mesh([["cpu"], ["cpu"]], ("data", "pod")),
                                 seq_parallel=True)
    with pytest.raises(ValueError, match="experts do not split"):
        _mesh_step(model, arch, _mesh(1, 3))
    # without a mesh the reference ignores both hints, and so does the port
    steps.make_lm_train_step(pcfg, seq_parallel=True, grad_specs={"x": P("nowhere")})


# --------------------------------------------------------------------------
# the partitioned GNN engine on a flattened 2-D mesh
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", gnn_t.ARCHS)
def test_gnn_engine_on_a_2d_mesh_equals_the_ring(arch):
    """A (2, 2) ("data", "model") mesh is the reference's flattened 4-stage
    ring: the loss and every gradient equal the engine's on a RingMesh of 4,
    bit for bit."""
    pcfg, model = gnn_t._model(arch)
    batch = gnn_t._batch(arch, 4)
    loss_fn = getattr(D, f"{pcfg.family}_distributed_loss")
    got = gnn_t._loss_and_grads(loss_fn(model, pcfg, _mesh(2, 2)), model, pcfg, batch)
    want = gnn_t._loss_and_grads(loss_fn(model, pcfg, make_ring_mesh(4, devices=["cpu"] * 4)),
                                 model, pcfg, batch)
    assert torch.equal(got[0], want[0])
    for g, w in zip(jax.tree.leaves(got[1]), jax.tree.leaves(want[1])):
        np.testing.assert_array_equal(g, w)


def test_gnn_train_step_on_a_2d_mesh_equals_the_ring():
    pcfg, a = gnn_t._model("gin_tu")
    _, b = gnn_t._model("gin_tu")
    batch = gnn_t._batch("gin_tu", 4)
    la = D.make_distributed_gnn_train_step(pcfg, _mesh(2, 2))(
        a, opt.init_state(dict(a.named_parameters())), batch)[2]["loss"]
    lb = D.make_distributed_gnn_train_step(pcfg, make_ring_mesh(4, devices=["cpu"] * 4))(
        b, opt.init_state(dict(b.named_parameters())), batch)[2]["loss"]
    assert torch.equal(la, lb)
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))


# --------------------------------------------------------------------------
# against the reference's mesh steps
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_step_matches_reference(ref, ref_params, arch):
    pcfg, mesh = get_smoke(arch), _mesh(*MESH)
    model = _model(ref_params, arch)
    loss, state = _mesh_step(model, arch, mesh, **_hints(model, arch, mesh))
    key = f"{arch}/{MESH[0]}x{MESH[1]}"
    np.testing.assert_allclose(float(loss), ref[f"{key}/loss"], rtol=LOSS_RTOL)
    _tree_close(lm_params_to_numpy(model, pcfg), ref, f"{key}/params", STEP_LEAF_TOL)
    _tree_close(lm_params_to_numpy(state["m"], pcfg), ref, f"{key}/m", STEP_LEAF_TOL)
    _tree_close(lm_params_to_numpy(state["v"], pcfg), ref, f"{key}/v", STEP_LEAF_TOL)


def test_moe_mesh_loss_is_the_expert_parallel_one(ref, ref_params):
    """On the MoE config the mesh loss is not the plain step's (tokens drop
    at the default capacity); on the dense config the mesh changes nothing,
    bit for bit."""
    key = f"{MOE_ARCH}/{MESH[0]}x{MESH[1]}"
    plain, _ = _mesh_step(_model(ref_params, MOE_ARCH), MOE_ARCH, None)
    assert abs(float(plain) - ref[f"{key}/loss"]) > 100 * LOSS_RTOL * abs(ref[f"{key}/loss"])
    dense_plain, s0 = _mesh_step(_model(ref_params, "yi_6b"), "yi_6b", None)
    dense_mesh, s1 = _mesh_step(_model(ref_params, "yi_6b"), "yi_6b", _mesh(*MESH))
    assert torch.equal(dense_plain, dense_mesh)
    assert all(torch.equal(s0["m"][k], s1["m"][k]) for k in s0["m"])


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_prefill_matches_reference(ref, ref_params, arch):
    pcfg, mesh = get_smoke(arch), _mesh(*MESH)
    logits, cache = steps.make_lm_prefill(pcfg, S_MAX, chunk_q=CHUNK_Q, mesh=mesh,
                                          seq_parallel=True)(_model(ref_params, arch),
                                                             _batch(arch)["tokens"])
    key = f"{arch}/{MESH[0]}x{MESH[1]}"
    _leaf_close(logits.numpy(), ref[f"{key}/logits"], LOGIT_TOL, "logits")
    _tree_close(jax.tree.map(lambda t: t.numpy(), cache), ref, f"{key}/cache", LOGIT_TOL)


@pytest.mark.parametrize("shape", OTHER_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_moe_mesh_steps_on_other_mesh_shapes(ref, ref_params, shape):
    pcfg, mesh = get_smoke(MOE_ARCH), _mesh(*shape)
    key = f"{MOE_ARCH}/{shape[0]}x{shape[1]}"
    model = _model(ref_params, MOE_ARCH)
    loss, _ = _mesh_step(model, MOE_ARCH, mesh, **_hints(model, MOE_ARCH, mesh))
    np.testing.assert_allclose(float(loss), ref[f"{key}/loss"], rtol=LOSS_RTOL)
    logits, _ = steps.make_lm_prefill(pcfg, S_MAX, chunk_q=CHUNK_Q, mesh=mesh,
                                      seq_parallel=True)(_model(ref_params, MOE_ARCH),
                                                         _batch(MOE_ARCH)["tokens"])
    _leaf_close(logits.numpy(), ref[f"{key}/logits"], LOGIT_TOL, "logits")
