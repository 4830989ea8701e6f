"""The port's expert-parallel MoE (``repro_torch.models.moe.moe_apply_ep``)
on CPU meshes against the reference's own ``moe_apply_ep``.

The reference runs in a subprocess with 8 forced host devices, on meshes
this file builds with Auto axes (``jax.sharding.Mesh(..., axis_types=
(Auto, Auto))``): the Explicit axes of ``jax.make_mesh``'s default refuse
the reference's gradient (ROADMAP.md §C), which is why
``tests/test_moe.py``'s EP test fails here. It writes its values to a file
(:func:`dump_reference`); the first test that needs one starts it. Weights
are the reference's ``moe_init`` from a seed copied into the port's
``MoE``; tokens are numpy from a seed. The port runs every coordinate on
the CPU (``make_local_mesh(..., devices=["cpu"] * n)``).

Four mesh shapes, (2, 4), (1, 4), (4, 2) and (1, 1), at three capacity
factors: 8.0 (nothing drops), 1.25 (the default) and 1.0 (tokens drop).
Tolerances: outputs at the reference test's rtol 2e-4 / atol 2e-5; ``aux``
at rtol 1e-6; each gradient leaf (of ``y.sum()`` and of ``aux``, for the
router and the three expert stacks) within 1e-5 of the leaf's largest
entry; at 8.0 the port's EP equals its own ``moe_apply`` to the same
bounds. Routing and drops are integers, compared exactly.
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
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch import Mesh, make_local_mesh, make_ring_mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ARCH = "deepseek_v2_lite_16b"
T = 64
MESHES = [(2, 4), (1, 4), (4, 2), (1, 1)]
FACTORS = [8.0, 1.25, 1.0]
LEAVES = ("router", "w_gate", "w_up", "w_down")
OUT_TOL = dict(rtol=2e-4, atol=2e-5)
AUX_RTOL = 1e-6
LEAF_TOL = 1e-5


def _ref_params():
    return ref_moe.moe_init(jax.random.PRNGKey(0), ref_get_smoke(ARCH), jnp.float32)


def _tokens(t=T, seed=1):
    return np.random.default_rng(seed).standard_normal((t, ref_get_smoke(ARCH).d_model)) \
        .astype(np.float32)


def _auto_mesh(data, model):
    devs = np.asarray(jax.devices()[:data * model]).reshape(data, model)
    return jax.sharding.Mesh(devs, ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)


def reference_values() -> dict:
    """The reference's EP at every mesh shape and capacity factor: y, aux,
    and the gradients of y.sum() and of aux for the router and the expert
    stacks. A flat dict of numpy arrays."""
    cfg, p, x = ref_get_smoke(ARCH), _ref_params(), jnp.asarray(_tokens())
    out = {}
    for data, model in MESHES:
        mesh = _auto_mesh(data, model)
        for cf in FACTORS:
            f = jax.jit(lambda p, x, mesh=mesh, cf=cf: ref_moe.moe_apply_ep(
                p, cfg, x, mesh=mesh, capacity_factor=cf))
            y, aux = f(p, x)
            gy = jax.jit(jax.grad(lambda p: f(p, x)[0].sum()))(p)
            ga = jax.jit(jax.grad(lambda p: f(p, x)[1]))(p)
            key = f"{data}x{model}/{cf}"
            out[f"{key}/y"], out[f"{key}/aux"] = np.asarray(y), np.asarray(aux)
            for name in LEAVES:
                out[f"{key}/gy/{name}"] = np.asarray(gy[name])
                out[f"{key}/ga/{name}"] = np.asarray(ga[name])
    return out


def dump_reference(path: str) -> None:
    """Entry point of the subprocess: :func:`reference_values` to ``path``."""
    assert jax.device_count() >= 8, jax.devices()
    np.savez(path, **reference_values())


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ep_ref") / "ref.npz")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(HERE, "..", "src"), HERE]))
    code = f"import test_torch_moe_ep as t\nt.dump_reference({path!r})\n"
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=HERE, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    with np.load(path) as f:
        return dict(f)


@pytest.fixture(scope="module")
def port():
    """(port cfg, the port's MoE holding the reference's weights)."""
    pcfg = get_smoke(ARCH)
    p = moe.MoE(pcfg, device="cpu")
    tree = jax.tree.map(np.asarray, _ref_params())
    with torch.no_grad():
        for name, t in p.named_parameters():
            leaf = tree
            for k in name.split("."):
                leaf = leaf[k]
            t.copy_(torch.from_numpy(np.array(leaf)))
    return pcfg, p


def _mesh(data, model):
    return make_local_mesh(data=data, model=model, devices=["cpu"] * (data * model))


def _leaf_close(got, want, where):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= LEAF_TOL * scale, f"{where}: max |diff| {err:.3e} > {LEAF_TOL} * {scale:.3e}"


def _ep_and_grads(p, pcfg, x, mesh, cf):
    params = [getattr(p, name) for name in LEAVES]
    for t in p.parameters():
        t.requires_grad_(True)
    try:
        y, aux = moe.moe_apply_ep(p, pcfg, torch.from_numpy(x), mesh=mesh, capacity_factor=cf)
        gy = torch.autograd.grad(y.sum(), params, retain_graph=True)
        ga = torch.autograd.grad(aux, params, allow_unused=True, materialize_grads=True)
    finally:
        for t in p.parameters():
            t.requires_grad_(False)
    return y.detach(), aux.detach(), gy, ga


def _drops_numpy(top_i: np.ndarray, n_rows: int, e: int, cap: int) -> int:
    """Slots at or past their expert's capacity, counted row by row in slot
    order: a loop over the reference's routing, independent of the port."""
    dropped = 0
    for row in top_i.reshape(n_rows, -1):
        seen = np.zeros(e, np.int64)
        for ex in row:
            dropped += seen[ex] >= cap
            seen[ex] += 1
    return int(dropped)


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_moe_apply_ep_matches_reference(ref, port, shape, cf):
    pcfg, p = port
    key = f"{shape[0]}x{shape[1]}/{cf}"
    y, aux, gy, ga = _ep_and_grads(p, pcfg, _tokens(), _mesh(*shape), cf)
    np.testing.assert_allclose(y.numpy(), ref[f"{key}/y"], **OUT_TOL)
    np.testing.assert_allclose(aux.numpy(), ref[f"{key}/aux"], rtol=AUX_RTOL)
    for name, g, h in zip(LEAVES, gy, ga):
        _leaf_close(g.numpy(), ref[f"{key}/gy/{name}"], f"{key} d(y.sum)/d{name}")
        _leaf_close(h.numpy(), ref[f"{key}/ga/{name}"], f"{key} d(aux)/d{name}")


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ep_at_a_generous_capacity_equals_moe_apply(port, shape):
    """At capacity 8.0 (no slot can drop) the EP output, aux and gradients
    equal the port's single-device moe_apply where rows agree (aux on one
    data row is the whole batch's)."""
    pcfg, p = port
    x = _tokens()
    y, aux, gy, _ = _ep_and_grads(p, pcfg, x, _mesh(*shape), 8.0)
    params = [getattr(p, name) for name in LEAVES]
    for t in p.parameters():
        t.requires_grad_(True)
    try:
        want, want_aux = moe.moe_apply(p, pcfg, torch.from_numpy(x))
        want_g = torch.autograd.grad(want.sum(), params)
    finally:
        for t in p.parameters():
            t.requires_grad_(False)
    np.testing.assert_allclose(y.numpy(), want.detach().numpy(), **OUT_TOL)
    for name, g, w in zip(LEAVES, gy, want_g):
        _leaf_close(g.numpy(), w.numpy(), f"d(y.sum)/d{name}")
    if shape[0] == 1:
        np.testing.assert_allclose(aux.numpy(), want_aux.detach().numpy(), rtol=AUX_RTOL)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_ep_aux_value_is_row_0_and_its_gradient_the_rows_mean(ref, port, shape):
    """The reference returns data row 0's aux through a replicated output
    with no psum, and its gradient is the mean of the rows' (ROADMAP.md §C):
    the port's value equals moe_apply's aux on row 0's tokens, not the rows'
    mean, and its router gradient equals the mean of the rows' gradients."""
    pcfg, p = port
    x = _tokens()
    t_loc = T // shape[0]
    _, aux, _, ga = _ep_and_grads(p, pcfg, x, _mesh(*shape), 8.0)
    p.router.requires_grad_(True)
    try:
        rows = [moe.moe_apply(p, pcfg, torch.from_numpy(x[r * t_loc:(r + 1) * t_loc]))[1]
                for r in range(shape[0])]
        row_grads = [torch.autograd.grad(a, [p.router])[0] for a in rows]
    finally:
        p.router.requires_grad_(False)
    rows = [float(a.detach()) for a in rows]
    np.testing.assert_allclose(float(aux), rows[0], rtol=AUX_RTOL)
    assert abs(float(aux) - np.mean(rows)) > 100 * AUX_RTOL * abs(np.mean(rows))
    _leaf_close(ga[0].numpy(), torch.stack(row_grads).mean(0).numpy(), "d(aux)/d router")
    _leaf_close(ga[0].numpy(), ref[f"{shape[0]}x{shape[1]}/8.0/ga/router"], "reference")


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ep_dropped_counts_the_reference_routings_drops(port, shape, cf):
    """``ep_dropped`` against a loop over the reference's own top-k: at 8.0
    none, at 1.0 some on every mesh shape."""
    pcfg, p = port
    cfg = ref_get_smoke(ARCH)
    x = _tokens()
    scores = jax.nn.softmax(jnp.asarray(x) @ _ref_params()["router"], axis=-1)
    _, top_i = jax.lax.top_k(scores, cfg.moe.top_k)
    cap = moe.ep_capacity(T // shape[0], pcfg, cf)
    assert cap == max(1, int(T // shape[0] * cfg.moe.top_k / cfg.moe.n_routed * cf))
    want = _drops_numpy(np.asarray(top_i), shape[0], cfg.moe.n_routed, cap)
    got = moe.ep_dropped(p, pcfg, torch.from_numpy(x), mesh=_mesh(*shape), capacity_factor=cf)
    assert got == want / (T * cfg.moe.top_k)
    assert (want == 0) if cf == 8.0 else (want > 0) if cf == 1.0 else True


def test_ep_in_bf16_stays_near_f32(port):
    """bf16 tokens and expert stacks: the output in bf16, within 2e-2 of
    the largest f32 output (bf16 rounding of the expert products)."""
    pcfg, p = port
    mesh = _mesh(2, 4)
    x = torch.from_numpy(_tokens())
    want, _ = moe.moe_apply_ep(p, pcfg, x, mesh=mesh)
    p16 = moe.MoE(pcfg, torch.bfloat16, device="cpu")
    p16.load_state_dict(p.state_dict())
    got, aux = moe.moe_apply_ep(p16, pcfg, x.bfloat16(), mesh=mesh)
    assert got.dtype == torch.bfloat16 and aux.dtype == torch.float32
    err = float((got.float() - want).abs().max())
    assert err <= 2e-2 * float(want.abs().max()), err


def test_ep_raises_on_meshes_it_cannot_split_over(port):
    pcfg, p = port
    x = torch.from_numpy(_tokens())
    with pytest.raises(ValueError, match="experts do not split"):
        moe.moe_apply_ep(p, pcfg, x, mesh=_mesh(1, 3))  # 8 experts over 3
    with pytest.raises(ValueError, match="tokens do not split"):
        moe.moe_apply_ep(p, pcfg, x[:63], mesh=_mesh(2, 4))
    with pytest.raises(ValueError, match="no 'model' axis"):
        moe.moe_apply_ep(p, pcfg, x, mesh=Mesh(["cpu"] * 2, ("data",)))
    with pytest.raises(ValueError, match="no 'model' axis"):
        moe.moe_apply_ep(p, pcfg, x, mesh=make_ring_mesh(2, devices=["cpu"] * 2))


def test_ep_on_a_three_axis_mesh_splits_tokens_over_pod_and_data(port):
    """(pod, data, model) = (2, 2, 2): four data rows, pod major, as the
    reference's spec P(("pod", "data")) splits the tokens; the same rows as
    a (4, 2) ("data", "model") mesh."""
    pcfg, p = port
    x = torch.from_numpy(_tokens())
    m3 = Mesh(np.array(["cpu"] * 8, dtype=object).reshape(2, 2, 2), ("pod", "data", "model"))
    got, aux = moe.moe_apply_ep(p, pcfg, x, mesh=m3, capacity_factor=1.0)
    want, want_aux = moe.moe_apply_ep(p, pcfg, x, mesh=_mesh(4, 2), capacity_factor=1.0)
    assert torch.equal(got, want) and torch.equal(aux, want_aux)
