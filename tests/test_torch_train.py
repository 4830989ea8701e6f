"""The port's training path against the reference: the losses and their
gradients, AdamW, int8 gradient compression, the data pipelines,
``CheckpointManager`` (checkpoints cross between the packages both ways),
the train steps and ``train_lm``'s exact restart, at the smoke configs.

Weights are the reference's ``init_params`` pytree carried across by
``repro_torch.convert``; gradients and moments come back to the
reference's tree by ``convert.lm_params_to_numpy`` /
``recsys_params_to_numpy`` and are compared leaf by leaf. Tolerances, in
float32: a loss within rtol 1e-5; a gradient, moment or parameter leaf
within 1e-5 of its largest entry (``_leaf_close``: max |got - want| <=
1e-5 * max |want|, so entries that cancel to float noise do not count as
relative error). Three train steps in a row: losses rtol 1e-5, parameters
1e-4 of each leaf's largest entry (AdamW's first steps move every entry by
about lr · sign(g), so a gradient entry at float noise can flip). Integer
results (quantized gradients, data batches, checkpoint bits) are compared
exactly."""
import json
import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.launch.train import train_lm as ref_train_lm  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.models.recsys import autoint as ref_autoint  # noqa: E402
from repro.train import compression as ref_comp  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
from repro.train.checkpoint import CheckpointManager as RefCheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    lm_params_from_numpy,
    lm_params_to_numpy,
    lm_params_to_tree,
    recsys_params_from_numpy,
    recsys_params_to_numpy,
)
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels.embedding_bag.ops import embedding_bag  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.launch.train import train_lm  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.recsys import autoint, embedding  # noqa: E402
from repro_torch.train import compression as comp  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["yi_6b", "granite_8b", "nemotron_4_15b", "deepseek_v2_lite_16b", "deepseek_v2_236b"]
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-5
STEP_LEAF_TOL = 1e-4
CE_CHUNK = 4  # ragged against S = 13


def _leaf_close(got, want, tol=LEAF_TOL, where=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (where, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{where}: max |diff| {err:.3e} > {tol} * {scale:.3e}"


def _trees_close(got, want, tol=LEAF_TOL):
    gl = jax.tree_util.tree_flatten_with_path(got)[0]
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        _leaf_close(g, w, tol, jax.tree_util.keystr(path))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _lm_batch(cfg, seed, b=2, s=13):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}


# the reference's init, jitted (eagerly its vmapped layer init compiles op by op)
_ref_init = jax.jit(ref_tf.init_params, static_argnums=(1,))


def _lm_case(arch, seed=0):
    """(reference cfg, reference params, port cfg) of one LM smoke config."""
    cfg = ref_get_smoke(arch)
    return cfg, _ref_init(jax.random.PRNGKey(seed), cfg), get_smoke(arch)


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    return _lm_case(request.param)


def _port_model(params, pcfg):
    return lm_params_from_numpy(_np_tree(params), pcfg, device="cpu").requires_grad_()


# ---------------------------------------------------------------------------
# Fault: the model functions were no-grad
# ---------------------------------------------------------------------------
def test_forward_is_differentiable():
    """The gradient of forward(...)[0].sum() with respect to the embedding
    equals the reference's (every other leaf: the loss_fn test below)."""
    cfg, params, pcfg = _lm_case("yi_6b")
    tokens = _lm_batch(cfg, 3)["tokens"]
    want = jax.jit(jax.grad(lambda p: ref_tf.forward(p, cfg, jnp.asarray(tokens),
                                                     chunk_q=8)[0].sum()))(params)["embed"]
    model = _port_model(params, pcfg)
    logits, _ = tf.forward(model, pcfg, torch.from_numpy(tokens), chunk_q=8)
    assert logits.requires_grad
    (got,) = torch.autograd.grad(logits.sum(), [model.embed])
    _leaf_close(got.numpy(), want, where="d embed")


def test_serving_entry_points_record_no_graph(lm):
    cfg, params, pcfg = lm
    model = _port_model(params, pcfg)
    tokens = torch.from_numpy(_lm_batch(cfg, 4)["tokens"])
    logits, cache = tf.prefill(model, pcfg, tokens, 16, chunk_q=8)
    assert not logits.requires_grad
    assert not any(a.requires_grad for d in cache.values() for a in d.values())
    step_logits, _ = tf.decode_step(model, pcfg, cache, tokens[:, :1], tokens.shape[1])
    assert not step_logits.requires_grad
    with torch.no_grad():
        assert not tf.forward(model, pcfg, tokens, chunk_q=8)[0].requires_grad


# ---------------------------------------------------------------------------
# Losses and gradients
# ---------------------------------------------------------------------------
def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    want, want_g = jax.value_and_grad(ref_layers.cross_entropy)(jnp.asarray(logits),
                                                                 jnp.asarray(labels))
    x = torch.from_numpy(logits).requires_grad_()
    got = layers.cross_entropy(x, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    _leaf_close(x.grad.numpy(), want_g)


@pytest.mark.parametrize("s,chunk", [(13, 4), (16, 4), (5, 8), (9, 9)])
def test_chunked_cross_entropy_matches_reference_with_padding_labels(s, chunk):
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 12)).astype(np.float32)
    w = rng.standard_normal((12, 40)).astype(np.float32) * 0.5
    labels = rng.integers(0, 40, (2, s)).astype(np.int32)
    labels[0, -2:] = -1  # padding
    labels[1, 0] = -1
    f = jax.value_and_grad(lambda a, b: ref_layers.chunked_cross_entropy(
        a, b, jnp.asarray(labels), chunk=chunk), argnums=(0, 1))
    want, (gx, gw) = f(jnp.asarray(x), jnp.asarray(w))
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    got = layers.chunked_cross_entropy(xt, wt, torch.from_numpy(labels), chunk=chunk)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    _leaf_close(xt.grad.numpy(), gx, where="dx")
    _leaf_close(wt.grad.numpy(), gw, where="dw")
    with torch.no_grad():  # and equal to the full cross-entropy over the real labels
        keep = torch.from_numpy(labels) >= 0
        full = torch.nn.functional.cross_entropy(
            (xt @ wt)[keep], torch.from_numpy(labels)[keep].long(), reduction="sum")
        np.testing.assert_allclose(got.item(), full.item() / labels.size, rtol=LOSS_RTOL)


_REF_LOSS = {}


def _ref_value_and_grad(cfg, params, batch, ce_chunk):
    """The reference's loss and gradient tree, its step jitted once per
    (config, ce_chunk); remat only recomputes, so it runs without."""
    key = (cfg.name, ce_chunk)
    if key not in _REF_LOSS:
        _REF_LOSS[key] = jax.jit(jax.value_and_grad(
            lambda p, b: ref_tf.loss_fn(p, cfg, b, chunk_q=8, ce_chunk=ce_chunk)))
    return _REF_LOSS[key](params, batch)


@pytest.mark.parametrize("ce_chunk", [None, CE_CHUNK])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_fn_and_every_gradient_leaf_match_reference(lm, remat, ce_chunk):
    cfg, params, pcfg = lm
    batch = _lm_batch(cfg, 1)
    want, want_g = _ref_value_and_grad(cfg, params, batch, ce_chunk)
    model = _port_model(params, pcfg)
    got = tf.loss_fn(model, pcfg, batch, chunk_q=8, remat=remat, ce_chunk=ce_chunk)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(got, [p for _, p in model.named_parameters()])
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    _trees_close(lm_params_to_numpy(dict(zip(names, grads)), pcfg), _np_tree(want_g))


def test_moe_aux_loss_enters_loss_fn_with_its_coefficient():
    cfg = get_smoke("deepseek_v2_lite_16b")
    model = tf.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = _lm_batch(cfg, 2)
    logits, aux = tf.forward(model, cfg, torch.from_numpy(batch["tokens"]), chunk_q=8)
    ce = layers.cross_entropy(logits, torch.from_numpy(batch["labels"]))
    assert tf.AUX_COEF == ref_tf.AUX_COEF and aux.item() > 0
    np.testing.assert_allclose(tf.loss_fn(model, cfg, batch, chunk_q=8).item(),
                               (ce + tf.AUX_COEF * aux).item(), rtol=1e-6)


@pytest.fixture(scope="module")
def rec():
    cfg = ref_get_smoke("autoint")
    return cfg, ref_autoint.init_params(jax.random.PRNGKey(0), cfg), get_smoke("autoint")


def test_bce_loss_and_its_gradients_match_reference(rec):
    cfg, params, pcfg = rec
    batch = pipeline.RecsysPipeline(pcfg, 16, seed=3).batch_at(0)
    want, want_g = jax.jit(jax.value_and_grad(ref_autoint.bce_loss), static_argnums=(1,))(
        params, cfg, batch)
    model = recsys_params_from_numpy(_np_tree(params), pcfg, device="cpu").requires_grad_()
    got = autoint.bce_loss(model, pcfg, batch)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(got, [p for _, p in model.named_parameters()],
                                allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    _trees_close(recsys_params_to_numpy(dict(zip(names, grads)), pcfg), _np_tree(want_g))


# ---------------------------------------------------------------------------
# Fault: K6 and K7 dropped autograd on the card; they raise on both devices
# ---------------------------------------------------------------------------
def test_k6_and_k7_refuse_inputs_that_require_grad():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 8, 16)).astype(np.float32))
               for _ in range(3))
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q.requires_grad_(), k, v)
    with torch.no_grad():
        assert flash_attention(q, k, v).shape == (1, 2, 8, 16)
    table = torch.zeros((10, 4), requires_grad=True)
    ids = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward"):
        embedding_bag(table, ids)
    with torch.no_grad():
        assert embedding_bag(table, ids).shape == (3, 4)
    cfg = get_smoke("yi_6b")
    model = tf.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = _lm_batch(cfg, 0)
    tf.loss_fn(model, cfg, batch, use_flash=True)  # weights without grad: no graph, runs
    with pytest.raises(RuntimeError, match="no backward"):
        tf.loss_fn(model.requires_grad_(), cfg, batch, use_flash=True)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["f32", "huge_grad_clip", "bf16"])
def test_three_adamw_updates_match_reference(case):
    rng = np.random.default_rng(7)
    shapes = {"a": (5, 3), "b": {"c": (4,), "d": (2, 2, 3)}}
    p0 = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                      is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32)
                          * (1e9 if case == "huge_grad_clip" else 0.3), shapes,
                          is_leaf=lambda x: isinstance(x, tuple)) for _ in range(3)]
    cfg = ref_opt.AdamWConfig(lr=1e-2)
    pcfg = opt.AdamWConfig(lr=1e-2)
    dt, tdt = (jnp.bfloat16, torch.bfloat16) if case == "bf16" else (jnp.float32,
                                                                      torch.float32)
    ref_p = jax.tree.map(lambda a: jnp.asarray(a, dt), p0)
    ref_s = ref_opt.init_state(ref_p)
    port_p = jax.tree.map(lambda a: torch.from_numpy(a).to(tdt), p0)
    port_s = opt.init_state(port_p)
    assert port_s["step"].dtype == torch.int32
    assert all(m.dtype == torch.float32 for m in jax.tree.leaves(port_s["m"]))
    for g in grads:
        ref_p, ref_s = ref_opt.update(ref_p, jax.tree.map(jnp.asarray, g), ref_s, cfg)
        got_p, port_s = opt.update(port_p, jax.tree.map(torch.from_numpy, g), port_s, pcfg)
        assert got_p is port_p  # in place
        np.testing.assert_allclose(
            opt.global_norm(jax.tree.map(torch.from_numpy, g)).item(),
            float(ref_opt.global_norm(g)), rtol=1e-6)
    assert int(port_s["step"]) == int(ref_s["step"]) == 3
    for name in ("m", "v"):
        _trees_close(jax.tree.map(lambda t: t.numpy(), port_s[name]), _np_tree(ref_s[name]))
    got = jax.tree.map(lambda t: t.float().numpy(), port_p)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), ref_p)
    # bf16 parameters: updated in f32 and rounded back, within one bf16 ulp
    tol = dict(rtol=2**-7, atol=0) if case == "bf16" else dict(rtol=1e-6, atol=1e-7)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, **tol), got, want)
    if case == "huge_grad_clip":  # the clip bounds the update
        assert all(np.all(np.abs(a - np.asarray(b)) < 10 * 1e-2 * 3)
                   for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(p0)))


def test_adamw_decreases_a_quadratic():
    gen = torch.Generator().manual_seed(0)
    target = torch.randn(32, generator=gen)
    params = {"w": torch.zeros(32)}
    state = opt.init_state(params)
    cfg = opt.AdamWConfig(lr=0.05, weight_decay=0.0)
    loss = lambda w: torch.sum(torch.square(w - target))  # noqa: E731
    l0 = loss(params["w"]).item()
    for _ in range(200):
        w = params["w"].clone().requires_grad_()
        (g,) = torch.autograd.grad(loss(w), [w])
        opt.update(params, {"w": g}, state, cfg)
    assert loss(params["w"]).item() < 0.01 * l0


def test_adamw_grad_clip_bounds_the_update():
    params = {"w": torch.zeros(4)}
    state = opt.init_state(params)
    opt.update(params, {"w": torch.full((4,), 1e9)}, state,
               opt.AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0))
    assert torch.all(params["w"].abs() < 10.0)


def test_adamw_takes_a_model_and_its_gradients_by_name():
    cfg = get_smoke("yi_6b")
    model = tf.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    state = opt.init_state(model)
    assert set(state["m"]) == {n for n, _ in model.named_parameters()}
    before = model.embed.clone()
    grads = {n: torch.ones_like(p) for n, p in model.named_parameters()}
    opt.update(model, grads, state, opt.AdamWConfig())
    assert not torch.equal(before, model.embed) and int(state["step"]) == 1


# ---------------------------------------------------------------------------
# Gradient compression
# ---------------------------------------------------------------------------
def test_quantize_gives_the_reference_integers():
    rng = np.random.default_rng(0)
    for g in (rng.standard_normal((64,)) * 3, rng.standard_normal((8, 9)) * 1e-3,
              np.zeros(5), np.array([0.5, -0.5, 1.5, 127.0 / 254])):
        g = g.astype(np.float32)
        q, s = comp.quantize(torch.from_numpy(g))
        rq, rs = ref_comp.quantize(jnp.asarray(g))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_allclose(s.item(), float(rs), rtol=1e-7)
        np.testing.assert_allclose(comp.dequantize(q, s).numpy(),
                                   np.asarray(ref_comp.dequantize(rq, rs)), rtol=1e-7)


def test_quantize_roundtrip_error_is_bounded():
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(64,)) * 3).float()
    q, s = comp.quantize(g)
    assert (comp.dequantize(q, s) - g).abs().max().item() <= s.item() * 0.5 + 1e-6


def test_error_feedback_matches_reference_and_flushes():
    grads = {"w": torch.tensor([1e-6, 2.0, -2.0])}  # the tiny value vanishes in int8
    res = comp.init_residuals(grads)
    qs, ss, res = comp.compress_with_feedback(grads, res)
    rqs, rss, rres = ref_comp.compress_with_feedback({"w": jnp.asarray([1e-6, 2.0, -2.0])},
                                                     ref_comp.init_residuals(
                                                         {"w": jnp.zeros(3)}))
    np.testing.assert_array_equal(qs["w"].numpy(), np.asarray(rqs["w"]))
    np.testing.assert_allclose(res["w"].numpy(), np.asarray(rres["w"]), rtol=1e-6)
    assert abs(res["w"][0].item()) > 0  # kept in the residual, not lost
    total = comp.dequantize(qs["w"], ss["w"])
    for _ in range(300):
        qs, ss, res = comp.compress_with_feedback({"w": torch.zeros(3)}, res)
        total = total + comp.dequantize(qs["w"], ss["w"])
    np.testing.assert_allclose(total.numpy(), grads["w"].numpy(), atol=1e-4)


def test_compressed_sgd_converges():
    target = torch.randn(16, generator=torch.Generator().manual_seed(1))
    w = torch.zeros(16)
    res = comp.init_residuals({"w": w})
    for _ in range(300):
        qs, ss, res = comp.compress_with_feedback({"w": w - target}, res)  # grad of ½|w-t|²
        w = w - 0.1 * comp.dequantize(qs["w"], ss["w"])
    assert 0.5 * torch.sum(torch.square(w - target)).item() < 1e-3


# ---------------------------------------------------------------------------
# Data pipelines
# ---------------------------------------------------------------------------
def test_pipeline_batches_equal_the_reference_bit_for_bit():
    for arch in ("yi_6b", "deepseek_v2_lite_16b"):
        ref = ref_pipeline.LMTokenPipeline(ref_get_smoke(arch), 3, 17, seed=5)
        got = pipeline.LMTokenPipeline(get_smoke(arch), 3, 17, seed=5)
        for step in (0, 1, 9):
            a, b = got.batch_at(step), ref.batch_at(step)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    ref = ref_pipeline.RecsysPipeline(ref_get_smoke("autoint"), 32, seed=2)
    got = pipeline.RecsysPipeline(get_smoke("autoint"), 32, seed=2)
    for step in (0, 4):
        a, b = got.batch_at(step), ref.batch_at(step)
        for k in ("sparse_ids", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    ref_blocks = list(ref_pipeline.GraphStreamPipeline(300, 0.05, seed=4).edge_stream(500))
    got_blocks = list(pipeline.GraphStreamPipeline(300, 0.05, seed=4).edge_stream(500))
    assert len(got_blocks) == len(ref_blocks) > 2
    for a, b in zip(got_blocks, ref_blocks):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Converters
# ---------------------------------------------------------------------------
def test_lm_params_to_numpy_is_the_exact_inverse(lm):
    cfg, params, pcfg = lm
    tree = _np_tree(params)
    back = lm_params_to_numpy(lm_params_from_numpy(tree, pcfg, device="cpu"), pcfg)
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    bf = tf.init_params(torch.Generator().manual_seed(0), pcfg, torch.bfloat16, device="cpu")
    t = lm_params_to_tree(bf, pcfg)
    assert t["embed"].dtype == torch.bfloat16 and t["final_norm"].dtype == torch.float32


def test_recsys_params_to_numpy_is_the_exact_inverse(rec):
    cfg, params, pcfg = rec
    tree = _np_tree(params)
    back = recsys_params_to_numpy(recsys_params_from_numpy(tree, pcfg, device="cpu"), pcfg)
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    assert jax.tree.structure(back) == jax.tree.structure(tree)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.int32)}, "l": [torch.zeros(2), np.ones(3)]}
    for step in (1, 2, 3):
        mgr.save(step, {"a": tree["a"] * step, "b": {"c": tree["b"]["c"] * step},
                        "l": tree["l"]})
    mgr.wait()
    assert mgr.all_steps() == [2, 3]  # gc keeps 2
    got = mgr.restore(3, tree)
    assert torch.equal(got["a"], tree["a"] * 3) and torch.equal(got["b"]["c"], tree["b"]["c"] * 3)
    assert got["b"]["c"].dtype == torch.int32 and isinstance(got["l"][1], np.ndarray)


def test_checkpoint_save_copies_before_returning(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    x = torch.zeros(1000)
    mgr.save(1, {"x": x})
    x.add_(1)  # a train step updates in place while the writer runs
    mgr.wait()
    assert torch.equal(mgr.restore(1, {"x": x})["x"], torch.zeros(1000))


def test_checkpoint_atomicity_partial_write_invisible(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(tmp_path / ".tmp_step_9", exist_ok=True)
    assert mgr.latest_step() is None
    mgr.save(1, {"x": torch.zeros(3)}, blocking=True)
    assert mgr.latest_step() == 1


def test_checkpoint_write_failure_surfaces_on_wait(tmp_path, monkeypatch):
    from repro_torch.train import checkpoint

    def full_disk(*args, **kwargs):
        raise OSError("no space left on device")

    monkeypatch.setattr(checkpoint.np, "savez", full_disk)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.zeros(3)})
    with pytest.raises(OSError, match="no space"):
        mgr.wait()
    assert mgr.latest_step() is None


def test_bf16_leaves_restore_bit_exact(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    x = torch.randn(7, 5, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    mgr.save(2, {"w": x, "s": torch.tensor(3, dtype=torch.int32)}, blocking=True)
    with open(tmp_path / "step_000000000002" / "manifest.json") as f:
        assert [l["dtype"] for l in json.load(f)["leaves"]] == ["int32", "bfloat16"]
    got = mgr.restore(2, {"w": torch.zeros(7, 5, dtype=torch.bfloat16),
                          "s": torch.tensor(0, dtype=torch.int32)})
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), x.view(torch.int16))
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore(2, {"nope": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(2, {"w": torch.zeros(5, 7), "s": torch.tensor(0)})


def _trained_tree(lm_case):
    cfg, params, pcfg = lm_case
    model = lm_params_from_numpy(_np_tree(params), pcfg, device="cpu")
    return {"params": lm_params_to_tree(model, pcfg),
            "opt": {"m": lm_params_to_tree(model, pcfg), "v": lm_params_to_tree(model, pcfg),
                    "step": torch.tensor(4, dtype=torch.int32)}}


def test_reference_checkpoints_restore_in_the_port_and_the_reverse(tmp_path):
    cfg, params, pcfg = _lm_case("deepseek_v2_lite_16b", seed=1)
    tree = {"params": params, "opt": ref_opt.init_state(params)}
    tree["opt"]["step"] = jnp.asarray(4, jnp.int32)
    tree["extra"] = {"bf": jnp.arange(6, dtype=jnp.float32).astype(jnp.bfloat16) / 3}
    RefCheckpointManager(str(tmp_path / "ref")).save(4, tree, blocking=True)
    port_tree = _trained_tree((cfg, params, pcfg))
    port_tree["extra"] = {"bf": torch.zeros(6, dtype=torch.bfloat16)}
    got = CheckpointManager(str(tmp_path / "ref")).restore(4, port_tree)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.float().numpy(),
                                                            np.asarray(b, np.float32)),
                 got, tree)
    assert torch.equal(got["extra"]["bf"].view(torch.int16),
                       torch.from_numpy(np.array(tree["extra"]["bf"]).view(np.int16)))
    del port_tree["extra"], tree["extra"]  # numpy without ml_dtypes has no bf16 to hand back
    # the reverse: the port writes, the reference restores, every key and value equal
    CheckpointManager(str(tmp_path / "port")).save(4, port_tree, blocking=True)
    back = RefCheckpointManager(str(tmp_path / "port")).restore(4, tree)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b.numpy()),
                 back, port_tree)
    # the same manifest, leaf for leaf, as the reference writes for the tree
    RefCheckpointManager(str(tmp_path / "ref2")).save(4, tree, blocking=True)
    manifests = []
    for d in ("port", "ref2"):
        with open(tmp_path / d / "step_000000000004" / "manifest.json") as f:
            manifests.append(json.load(f))
    assert manifests[0] == manifests[1]
    keys = [leaf["key"] for leaf in manifests[0]["leaves"]]
    assert "opt/step" in keys and "params/moe_stack/moe/shared/w_up" in keys


# ---------------------------------------------------------------------------
# Train steps and train_lm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_v2_lite_16b"])
def test_three_lm_train_steps_match_reference(arch):
    cfg, params, pcfg = _lm_case(arch, seed=2)
    ref_step = jax.jit(ref_steps.make_lm_train_step(cfg, chunk_q=8, ce_chunk=CE_CHUNK))
    step = steps.make_lm_train_step(pcfg, chunk_q=8, ce_chunk=CE_CHUNK)
    model = lm_params_from_numpy(_np_tree(params), pcfg, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    state, ref_state = opt.init_state(model), ref_opt.init_state(params)
    pipe = pipeline.LMTokenPipeline(pcfg, 2, 13, seed=1)
    for i in range(3):
        batch = pipe.batch_at(i)
        params, ref_state, ref_m = ref_step(params, ref_state, batch)
        out_model, state, m = step(model, state, batch)
        assert out_model is model and m["loss"].dim() == 0 and not m["loss"].requires_grad
        np.testing.assert_allclose(m["loss"].item(), float(ref_m["loss"]), rtol=LOSS_RTOL)
    assert not any(p.requires_grad for p in model.parameters())  # as it found them (C1)
    _trees_close(lm_params_to_numpy(model, pcfg), _np_tree(params), STEP_LEAF_TOL)
    _trees_close(lm_params_to_numpy(state["m"], pcfg), _np_tree(ref_state["m"]), STEP_LEAF_TOL)


def test_three_recsys_train_steps_and_the_serve_steps_match_reference(rec):
    cfg, params, pcfg = rec
    ref_step = jax.jit(ref_steps.make_recsys_train_step(cfg))
    step = steps.make_recsys_train_step(pcfg)
    model = recsys_params_from_numpy(_np_tree(params), pcfg, device="cpu")
    state, ref_state = opt.init_state(model), ref_opt.init_state(params)
    pipe = pipeline.RecsysPipeline(pcfg, 32, seed=0)
    for i in range(3):
        batch = pipe.batch_at(i)
        params, ref_state, ref_m = ref_step(params, ref_state, batch)
        model, state, m = step(model, state, batch)
        np.testing.assert_allclose(m["loss"].item(), float(ref_m["loss"]), rtol=LOSS_RTOL)
    _trees_close(recsys_params_to_numpy(model, pcfg), _np_tree(params), STEP_LEAF_TOL)
    ids = pipe.batch_at(9)["sparse_ids"][:4]
    cand = np.random.default_rng(0).standard_normal((50, pcfg.embed_dim)).astype(np.float32)
    got = steps.make_recsys_serve_step(pcfg)(model, ids)
    assert not got.requires_grad
    ref_serve = jax.jit(ref_steps.make_recsys_serve_step(cfg))
    ref_retrieval = jax.jit(ref_steps.make_recsys_retrieval_step(cfg))
    np.testing.assert_allclose(got.numpy(), ref_serve(params, ids), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(
        steps.make_recsys_retrieval_step(pcfg)(model, ids, cand).numpy(),
        ref_retrieval(params, ids, cand), rtol=1e-4, atol=1e-5)


def _raise(*args, **kwargs):
    raise RuntimeError("a loss that fails")


def test_a_train_step_leaves_requires_grad_as_it_found_it(rec, monkeypatch):
    """C1 (ROADMAP.md §C): after one LM and one recsys train step every
    weight's ``requires_grad`` is what it was before (a mixed set of flags
    included), also when the loss raises; then the flash forward (K6's
    plain version here) and K7's lookup run, and equal a fresh model's
    loaded with the trained weights."""
    cfg, params, pcfg = _lm_case("yi_6b")
    model = lm_params_from_numpy(_np_tree(params), pcfg, device="cpu")
    model.embed.requires_grad_(True)
    before = {n: p.requires_grad for n, p in model.named_parameters()}
    state = opt.init_state(model)
    steps.make_lm_train_step(pcfg, chunk_q=8)(model, state, _lm_batch(cfg, 4))
    assert {n: p.requires_grad for n, p in model.named_parameters()} == before
    model.embed.requires_grad_(False)
    tokens = torch.from_numpy(_lm_batch(cfg, 5)["tokens"])
    got, _ = tf.forward(model, pcfg, tokens, use_flash=True, chunk_q=8)
    fresh = lm_params_from_numpy(lm_params_to_numpy(model, pcfg), pcfg, device="cpu")
    want, _ = tf.forward(fresh, pcfg, tokens, use_flash=True, chunk_q=8)
    assert not got.requires_grad and torch.equal(got, want)

    rcfg, rparams, rpcfg = rec
    rmodel = recsys_params_from_numpy(_np_tree(rparams), rpcfg, device="cpu")
    rstate = opt.init_state(rmodel)
    batch = pipeline.RecsysPipeline(rpcfg, 8, seed=2).batch_at(0)
    steps.make_recsys_train_step(rpcfg)(rmodel, rstate, batch)
    assert not any(p.requires_grad for p in rmodel.parameters())
    bags = torch.from_numpy(np.random.default_rng(6).integers(
        0, rpcfg.vocab_per_field + 3, (4, rpcfg.n_sparse, 3)))
    got = embedding.lookup_multihot(rmodel.table, rpcfg, bags, use_kernel=True)
    rfresh = recsys_params_from_numpy(recsys_params_to_numpy(rmodel, rpcfg), rpcfg,
                                      device="cpu")
    assert torch.equal(got, embedding.lookup_multihot(rfresh.table, rpcfg, bags,
                                                      use_kernel=True))
    assert not autoint.ctr_logits(rmodel, rpcfg, torch.from_numpy(
        batch["sparse_ids"])).requires_grad

    monkeypatch.setattr(autoint, "bce_loss", _raise)
    with pytest.raises(RuntimeError, match="a loss that fails"):
        steps.make_recsys_train_step(rpcfg)(rmodel, rstate, batch)
    assert not any(p.requires_grad for p in rmodel.parameters())


def test_lm_prefill_and_serve_steps_match_reference():
    cfg, params, pcfg = _lm_case("yi_6b")
    model = lm_params_from_numpy(_np_tree(params), pcfg, device="cpu")
    tokens = _lm_batch(cfg, 5, s=9)["tokens"]
    logits, cache = steps.make_lm_prefill(pcfg, 12, chunk_q=4)(model, tokens)
    want, ref_cache = ref_steps.make_lm_prefill(cfg, 12, chunk_q=4)(params, tokens)
    _leaf_close(logits.numpy(), want, 2e-5)
    nxt = np.argmax(np.asarray(want), -1).astype(np.int32)[:, None]
    got, _ = steps.make_lm_serve_step(pcfg)(model, cache, nxt, 9)
    want, _ = ref_steps.make_lm_serve_step(cfg)(params, ref_cache, jnp.asarray(nxt),
                                                jnp.asarray(9, jnp.int32))
    _leaf_close(got.numpy(), want, 2e-5)


def _drop_step(directory, step):
    """Delete a saved step, so the next ``train_lm`` resumes from the one before."""
    shutil.rmtree(os.path.join(str(directory), f"step_{step:012d}"))


def test_train_lm_restarts_exactly(tmp_path):
    full = train_lm("yi_6b", steps=8, batch=2, seq=16, ckpt_dir=str(tmp_path), ckpt_every=4,
                    log_every=100, device="cpu")
    assert CheckpointManager(str(tmp_path)).all_steps() == [4, 8]
    _drop_step(tmp_path, 8)  # the run "died" after step 4's checkpoint
    resumed = train_lm("yi_6b", steps=8, batch=2, seq=16, ckpt_dir=str(tmp_path),
                       ckpt_every=4, log_every=100, device="cpu")
    assert len(resumed["losses"]) == 4
    np.testing.assert_array_equal(full["losses"][4:], resumed["losses"])
    assert full["final_loss"] < full["losses"][0]
    assert CheckpointManager(str(tmp_path)).all_steps() == [4, 8]


def test_train_lm_resumes_a_reference_checkpoint_and_the_reverse(tmp_path):
    """A reference ``train_lm`` checkpoint at step 4, resumed by the port's,
    gives the reference's uninterrupted losses 4-7; a port checkpoint at
    step 4, resumed by the reference's, gives the port's (rtol 1e-4)."""
    kw = dict(steps=8, batch=2, seq=16, ckpt_every=4, log_every=100)
    ref_full = ref_train_lm("yi_6b", **kw, ckpt_dir=str(tmp_path / "ref"))
    _drop_step(tmp_path / "ref", 8)
    port = train_lm("yi_6b", **kw, ckpt_dir=str(tmp_path / "ref"), device="cpu")
    np.testing.assert_allclose(port["losses"], ref_full["losses"][4:], rtol=1e-4)
    port_full = train_lm("yi_6b", **kw, ckpt_dir=str(tmp_path / "port"), device="cpu")
    _drop_step(tmp_path / "port", 8)
    ref = ref_train_lm("yi_6b", **kw, ckpt_dir=str(tmp_path / "port"))
    np.testing.assert_allclose(ref["losses"], port_full["losses"][4:], rtol=1e-4)


def test_train_lm_cli_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--steps", "1",
                        "--batch", "2", "--seq", "8", "--device", "cpu", "--ckpt-dir",
                        str(tmp_path)], env=env, cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "final loss:" in r.stdout
    assert CheckpointManager(str(tmp_path)).all_steps() == [1]


def test_train_lm_returns_the_reference_keys():
    """C2 (ROADMAP.md §C): ``train_lm`` returns the reference's keys, with
    ``"params"`` the reference's LM tree (leaf paths as the reference's) of
    the trained model, a host copy, beside the port's ``"model"`` and
    ``"opt_state"``. (The two packages draw other initial weights.)"""
    kw = dict(steps=2, batch=2, seq=8, log_every=100)
    got = train_lm("yi_6b", **kw, device="cpu")
    want = ref_train_lm("yi_6b", **kw)
    assert set(got) == set(want) | {"model", "opt_state"}
    leaves = tree_leaves(got["params"])
    assert all(t.device.type == "cpu" for t in leaves)
    tree = tree_map(lambda t: t.numpy(), got["params"])
    assert ([p for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
            == [p for p, _ in jax.tree_util.tree_flatten_with_path(want["params"])[0]])
    _trees_close(tree, lm_params_to_numpy(got["model"], get_smoke("yi_6b")), 0.0)
    embed = got["params"]["embed"].clone()
    with torch.no_grad():
        got["model"].embed.add_(1.0)  # "params" is a copy: it stays as it was
    assert torch.equal(got["params"]["embed"], embed)


def test_train_lm_needs_a_card_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lm("yi_6b", steps=1, batch=1, seq=4)

