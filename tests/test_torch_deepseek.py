"""The port's DeepSeek-V2 path (MLA, DeepSeekMoE) against the reference,
module by module, at the smoke configs of DeepSeek-V2-Lite (plain q
projection) and DeepSeek-V2 236B (q-LoRA).

Weights are the reference's ``init_params`` pytree carried across by
``repro_torch.convert.lm_params_from_numpy``; inputs are made with numpy
from a seed and fed to both packages. Everything is compared at
rtol = atol = 2e-4 (tests/test_lm_smoke.py's tolerance), and routing as
integers. With ``use_flash=True`` the reference runs its Pallas kernel in
interpret mode and the port K6's plain version (these tensors lie on the
CPU); the CUDA kernel at MLA's head dim is held against the same plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.serve.serve_loop import LMServer as RefLMServer  # noqa: E402
from repro.serve.serve_loop import ServeConfig as RefServeConfig  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.models import attention, moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve import LMServer, ServeConfig  # noqa: E402

ARCHS = ["deepseek_v2_lite_16b", "deepseek_v2_236b"]
TOL = dict(rtol=2e-4, atol=2e-4)

# The reference's functions, jitted here (cfg static): called eagerly, each
# call of a scanned entry point compiles its scan anew, and each new shape
# compiles op by op (about a second a call at these sizes)
_FLAGS = ("use_flash", "chunk_q")
_ref_prefill = jax.jit(ref_tf.prefill, static_argnums=(1, 3),
                       static_argnames=(*_FLAGS, "cache_dtype"))
_ref_decode = jax.jit(ref_tf.decode_step, static_argnums=(1,))
_ref_forward = jax.jit(ref_tf.forward, static_argnums=(1,), static_argnames=_FLAGS)
_ref_moe = jax.jit(ref_moe.moe_apply, static_argnums=(1,))
_ref_mla_full = jax.jit(ref_attn.mla_full, static_argnums=(1,), static_argnames=_FLAGS)
_ref_mla_fill = jax.jit(ref_attn.mla_prefill_cache, static_argnums=(1,))
_ref_mla_decode = jax.jit(ref_attn.mla_decode, static_argnums=(1,))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=ARCHS)
def ds(request):
    """(reference cfg, reference params, port cfg, port model) of one arch."""
    cfg = ref_get_smoke(request.param)
    params = ref_tf.init_params(jax.random.PRNGKey(0), cfg)
    pcfg = get_smoke(request.param)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), pcfg, device="cpu")
    return cfg, params, pcfg, model


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _moe_layer(params, i=0):
    return jax.tree.map(lambda a: a[i], params["moe_stack"])


def _rope(cfg, positions):
    return ref_layers.rotary_cos_sin(jnp.asarray(positions), cfg.mla.rope_head_dim,
                                     cfg.rope_theta)


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------
@pytest.mark.parametrize("t", [3, 37], ids=["T<E", "T>E"])
def test_moe_apply_matches_reference(ds, t):
    """Routing equal as integers, then y and the aux loss. At T = 3 (6
    copies over 8 experts) some expert gets no token."""
    cfg, params, pcfg, model = ds
    p_ref, p = _moe_layer(params, 1)["moe"], model.layers[2].moe
    x = np.random.default_rng(t).standard_normal((t, cfg.d_model)).astype(np.float32)
    scores = jax.nn.softmax(jnp.asarray(x) @ p_ref["router"], axis=-1)  # moe.py:42-43
    _, want_i = jax.lax.top_k(scores, cfg.moe.top_k)
    _, _, top_i = moe.route(p, pcfg, _t(x))
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(want_i))
    if t < cfg.moe.n_routed:
        assert len(np.unique(np.asarray(want_i))) < cfg.moe.n_routed
    want_y, want_aux = _ref_moe(p_ref, cfg, jnp.asarray(x))
    y, aux = moe.moe_apply(p, pcfg, _t(x))
    assert y.shape == (t, cfg.d_model) and aux.dtype == torch.float32 and aux.dim() == 0
    _close(y, want_y)
    _close(aux, want_aux)


# --------------------------------------------------------------------------
# MLA
# --------------------------------------------------------------------------
@pytest.mark.parametrize("use_flash", [False, True])
def test_mla_full_matches_reference(ds, use_flash):
    cfg, params, pcfg, model = ds
    x = np.random.default_rng(2).standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    cos, sin = _rope(cfg, np.arange(13))
    p_ref = _moe_layer(params)["attn"]
    want = _ref_mla_full(p_ref, cfg, jnp.asarray(x), cos, sin, use_flash=use_flash,
                             chunk_q=8)
    got = attention.mla_full(model.layers[1].attn, pcfg, _t(x), _t(cos), _t(sin),
                             use_flash=use_flash, chunk_q=8)
    _close(got, want)


@pytest.mark.parametrize("use_flash", [False, True])
def test_mla_full_at_deepseek_head_dims_matches_reference(use_flash):
    """MLA at DeepSeek-V2's own head dims (nope 128 + rope 64, v 128) on the
    V2-Lite smoke config's width: the port's flash path hands K6 (192, 128)
    with v unpadded, the reference pads v to 192 and slices."""
    def widen(c):
        return dataclasses.replace(c, mla=dataclasses.replace(
            c.mla, nope_head_dim=128, rope_head_dim=64, v_head_dim=128))

    cfg, pcfg = widen(ref_get_smoke(ARCHS[0])), widen(get_smoke(ARCHS[0]))
    p_ref = ref_attn.mla_init(jax.random.PRNGKey(3), cfg, jnp.float32)
    p = attention.MLA(pcfg, device="cpu")
    p.load_state_dict({k: _t(v) for k, v in p_ref.items()})
    x = np.random.default_rng(5).standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    cos, sin = _rope(cfg, np.arange(21))
    want = _ref_mla_full(p_ref, cfg, jnp.asarray(x), cos, sin, use_flash=use_flash, chunk_q=8)
    got = attention.mla_full(p, pcfg, _t(x), _t(cos), _t(sin), use_flash=use_flash, chunk_q=8)
    _close(got, want)


def test_mla_cache_fill_and_decode_match_reference(ds):
    """The latent cache filled in place, then three absorbed decode steps
    (an int position, then 0-d tensors), each writing its position of the
    same cache."""
    cfg, params, pcfg, model = ds
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    cos, sin = _rope(cfg, np.arange(7))
    p_ref = jax.tree.map(lambda a: a[0], params["dense"]["attn"])
    p = model.layers[0].attn
    ref_cache = _ref_mla_fill(p_ref, cfg, jnp.asarray(x), cos, sin,
                                           ref_attn.mla_cache_init(cfg, 2, 11, jnp.float32))
    cache = attention.mla_cache_init(pcfg, 2, 11, device="cpu")
    ptrs = {name: a.data_ptr() for name, a in cache.items()}
    assert attention.mla_prefill_cache(p, pcfg, _t(x), _t(cos), _t(sin), cache) is cache
    for name in ("c", "kr"):
        _close(cache[name], ref_cache[name])
    for step in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        c1, s1 = _rope(cfg, [7 + step])
        y_ref, ref_cache = _ref_mla_decode(p_ref, cfg, jnp.asarray(xt), c1, s1, ref_cache,
                                               jnp.int32(7 + step))
        pos = 7 + step if step == 0 else torch.tensor(7 + step)
        y, out = attention.mla_decode(p, pcfg, _t(xt), _t(c1), _t(s1), cache, pos)
        assert out is cache and {n: a.data_ptr() for n, a in cache.items()} == ptrs
        _close(y, y_ref)
    for name in ("c", "kr"):
        _close(cache[name], ref_cache[name])


# --------------------------------------------------------------------------
# The model
# --------------------------------------------------------------------------
@pytest.mark.parametrize("use_flash", [False, True])
def test_forward_matches_reference(ds, use_flash):
    """Logits and the summed aux loss of the MoE layers."""
    cfg, params, pcfg, model = ds
    toks = _tokens(cfg, (2, 16), 5)
    want, want_aux = _ref_forward(params, cfg, jnp.asarray(toks), use_flash=use_flash,
                                  chunk_q=8)
    got, aux = tf.forward(model, pcfg, _t(toks), use_flash=use_flash, chunk_q=8)
    assert got.dtype == torch.float32 and got.shape == (2, 16, cfg.vocab)
    assert float(aux) > 0
    _close(got, want)
    _close(aux, want_aux)


def test_cache_init_has_the_reference_layout(ds):
    cfg, _, pcfg, _ = ds
    want = ref_tf.cache_init(cfg, 3, 10)
    got = tf.cache_init(pcfg, 3, 10, device="cpu")
    assert set(got) == set(want) == {"dense", "moe_stack"}
    for stack in want:
        assert {n: tuple(a.shape) for n, a in got[stack].items()} == \
            {n: a.shape for n, a in want[stack].items()}
        assert all(not a.any() for a in got[stack].values())


@pytest.mark.parametrize("use_flash", [False, True])
def test_prefill_matches_reference(ds, use_flash):
    """Last-token logits and every cache entry of both stacks, all s_max
    positions (the unfilled tail stays 0)."""
    cfg, params, pcfg, model = ds
    toks = _tokens(cfg, (2, 11), 6)
    want, ref_cache = _ref_prefill(params, cfg, jnp.asarray(toks), 20,
                                   use_flash=use_flash, chunk_q=4)
    got, cache = tf.prefill(model, pcfg, _t(toks), 20, use_flash=use_flash, chunk_q=4)
    _close(got, want)
    for stack in ("dense", "moe_stack"):
        for name in ("c", "kr"):
            assert cache[stack][name].shape == ref_cache[stack][name].shape
            _close(cache[stack][name], ref_cache[stack][name])


def test_decode_step_matches_reference_and_writes_the_cache_in_place(ds):
    cfg, params, pcfg, model = ds
    toks = _tokens(cfg, (2, 12), 6)
    _, ref_cache = _ref_prefill(params, cfg, jnp.asarray(toks[:, :-1]), 20, chunk_q=4)
    _, cache = tf.prefill(model, pcfg, _t(toks[:, :-1]), 20, chunk_q=4)
    before = {(s, n): a.data_ptr() for s, d in cache.items() for n, a in d.items()}
    tok = toks[:, -1:]
    for step in range(3):
        want, ref_cache = _ref_decode(params, cfg, ref_cache, jnp.asarray(tok),
                                      jnp.int32(11 + step))
        got, out = tf.decode_step(model, pcfg, cache, _t(tok), 11 + step)
        assert out is cache
        assert {(s, n): a.data_ptr() for s, d in cache.items() for n, a in d.items()} == before
        _close(got, want)
        tok = np.asarray(jnp.argmax(want, -1))[:, None].astype(np.int32)
    for stack in ("dense", "moe_stack"):
        for name in ("c", "kr"):
            _close(cache[stack][name], ref_cache[stack][name])


def test_lm_server_generates_the_reference_tokens(ds):
    """A batch of left-padded mixed lengths: the same greedy tokens."""
    cfg, params, pcfg, model = ds
    lengths = (3, 9, 5, 7)
    rng = np.random.default_rng(sum(lengths))
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32) for n in lengths]
    scfg = dict(max_batch=4, max_new_tokens=5)
    want = RefLMServer(params, cfg, RefServeConfig(**scfg)).generate(prompts)
    got = LMServer(model, pcfg, ServeConfig(**scfg)).generate(prompts)
    assert len(got) == len(want) == len(prompts)
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.shape == (5,)
        np.testing.assert_array_equal(g, np.asarray(w))


def test_flash_prefill_on_the_cpu_launches_nothing(ds):
    _, _, pcfg, model = ds
    before = launch_counts()
    tf.prefill(model, pcfg, _t(_tokens(pcfg, (1, 5), 10)), 8, use_flash=True)
    assert launch_counts() == before


# --------------------------------------------------------------------------
# Weights: conversion and initialisation
# --------------------------------------------------------------------------
def test_lm_params_from_numpy_unstacks_the_moe_stack(ds):
    """Each MoE block's leaves are the moe_stack's, expert axis kept; a
    missing or misshaped leaf, or a short stack, raises."""
    cfg, params, pcfg, model = ds
    tree = jax.tree.map(np.asarray, params)
    for j, blk in enumerate(model.layers[1:]):
        assert blk.moe_layer and not model.layers[0].moe_layer
        np.testing.assert_array_equal(blk.moe.w_down.numpy(), tree["moe_stack"]["moe"]["w_down"][j])
        np.testing.assert_array_equal(blk.moe.shared.w_up.numpy(),
                                      tree["moe_stack"]["moe"]["shared"]["w_up"][j])
        np.testing.assert_array_equal(blk.attn.w_uk.numpy(), tree["moe_stack"]["attn"]["w_uk"][j])
    moe_tree = tree["moe_stack"]["moe"]
    missing = dict(tree, moe_stack=dict(tree["moe_stack"], moe={
        k: v for k, v in moe_tree.items() if k != "w_up"}))
    with pytest.raises(KeyError, match="moe_stack.moe.w_up"):
        lm_params_from_numpy(missing, pcfg, device="cpu")
    bad = dict(tree, moe_stack=dict(tree["moe_stack"], moe=dict(
        moe_tree, w_gate=moe_tree["w_gate"][:, :-1])))
    with pytest.raises(ValueError, match="moe_stack.moe.w_gate"):
        lm_params_from_numpy(bad, pcfg, device="cpu")
    short = jax.tree.map(lambda a: a[:1], tree["moe_stack"])
    with pytest.raises(ValueError, match="moe_stack stack holds 1 layers"):
        lm_params_from_numpy(dict(tree, moe_stack=short), pcfg, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_stacked_experts_at_their_fan_in_and_keeps_mla_norms_ones(arch):
    """Stacked (E, D, F) / (E, F, D) expert weights at D^-½ / F^-½, not at
    their expert axis's E^-½; every MLA projection at its fan-in; the norm
    scales and the router float32, the norms ones. Widths are raised so
    the stds are measured to a few percent."""
    base = get_smoke(arch)
    cfg = dataclasses.replace(base, d_model=256, moe=dataclasses.replace(
        base.moe, n_routed=4, d_ff_expert=512))
    g = torch.Generator().manual_seed(0)
    a = tf.init_params(g, cfg, torch.bfloat16, device="cpu")
    b = tf.init_params(torch.Generator().manual_seed(0), cfg, torch.bfloat16, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    m = a.layers[1].moe
    assert m.router.dtype == torch.float32 and m.w_gate.dtype == torch.bfloat16

    def near(w, std):  # five standard errors of a std estimated from w.numel() draws
        return abs(float(w.float().std()) - std) < 5 * (2 * w.numel()) ** -0.5 * std

    for w, std in ((m.router, 256**-0.5), (m.w_gate, 256**-0.5), (m.w_up, 256**-0.5),
                   (m.w_down, 512**-0.5), (m.shared.w_down, (cfg.moe.n_shared * 512) ** -0.5)):
        assert near(w, std)
    for blk in a.layers:
        for name, w in blk.attn.named_parameters():
            if name.endswith("_norm"):
                assert w.dtype == torch.float32 and bool((w == 1).all()), name
            else:
                assert near(w, w.shape[0] ** -0.5), name
    norms = cfg.n_layers * (cfg.mla.kv_lora_rank + (cfg.mla.q_lora_rank or 0))
    assert sum(p.numel() for p in a.parameters()) == cfg.n_params() + norms
    with pytest.raises(ValueError, match="w_gate"):
        from repro_torch.models.layers import fan_in_normal_
        fan_in_normal_(m, g)


# --------------------------------------------------------------------------
# bf16 (the dtype chip_smoke.py serves DeepSeek-V2-Lite in)
# --------------------------------------------------------------------------
BF16_REL = 2e-2  # of the largest |value|, as tests/test_torch_models.py's bf16 tests


def _close_rel(got, want, rel=BF16_REL):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert np.isfinite(got).all() and got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.fixture(scope="module", params=ARCHS)
def ds_bf16(request):
    """(reference cfg, reference bf16 params, port cfg, port bf16 model):
    the reference's ``init_params(dtype=bfloat16)`` carried across exactly
    (every bf16 value is an f32 value) into a bf16 model whose norm scales
    and router stay float32, as the reference's do."""
    cfg = ref_get_smoke(request.param)
    params = ref_tf.init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.bfloat16)
    pcfg = get_smoke(request.param)
    f32 = lm_params_from_numpy(jax.tree.map(np.asarray, params), pcfg, device="cpu")
    model = tf.Transformer(pcfg, torch.bfloat16, device="cpu")
    model.load_state_dict(f32.state_dict())
    return cfg, params, pcfg, model


def test_bf16_modules_match_reference(ds_bf16):
    """``moe_apply`` and ``mla_full`` (both ways) on the same bf16 inputs
    within 2e-2 of the largest value; the routing equal as integers."""
    cfg, params, pcfg, model = ds_bf16
    assert model.layers[1].moe.router.dtype == torch.float32
    assert model.layers[1].moe.w_gate.dtype == torch.bfloat16
    x = np.random.default_rng(11).standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    xb, xt = jnp.asarray(x, jnp.bfloat16), _t(x).to(torch.bfloat16)
    p_ref = _moe_layer(params)
    _, _, top_i = moe.route(model.layers[1].moe, pcfg, xt.reshape(18, -1))
    scores = jax.nn.softmax(xb.reshape(18, -1).astype(jnp.float32) @ p_ref["moe"]["router"], -1)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(jax.lax.top_k(scores, 2)[1]))
    want, _ = _ref_moe(p_ref["moe"], cfg, xb.reshape(18, -1))
    got, _ = moe.moe_apply(model.layers[1].moe, pcfg, xt.reshape(18, -1))
    assert got.dtype == torch.bfloat16
    _close_rel(got, want.astype(jnp.float32))
    cos, sin = _rope(cfg, np.arange(9))
    for use_flash in (False, True):
        want = _ref_mla_full(p_ref["attn"], cfg, xb, cos, sin, use_flash=use_flash)
        got = attention.mla_full(model.layers[1].attn, pcfg, xt, _t(cos), _t(sin),
                                 use_flash=use_flash)
        _close_rel(got, want.astype(jnp.float32))


@pytest.mark.parametrize("ds_bf16", ["deepseek_v2_lite_16b"], indirect=True)
def test_bf16_flash_prefill_and_decode_stay_near_f32_arithmetic(ds_bf16):
    """The flash prefill with a bf16 cache and one decode step: last-token
    logits no farther from f32 arithmetic on the same weights (the
    reference's f32 path) than twice the reference's own bf16 distance, as
    a fraction of the largest logit (FlashAttention's accuracy test, as
    chip_smoke.py holds the bf16 flash prefill). Over three layers each
    package's bf16 rounding alone moves these smoke logits 1-3% of the
    largest, so a fixed 2e-2 between the packages would test the noise.
    V2-Lite's config, the one served in bf16 (q-LoRA's bf16 arithmetic is
    held by ``test_bf16_modules_match_reference``)."""
    cfg, params, pcfg, model = ds_bf16
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    toks = _tokens(cfg, (2, 11), 6)
    exact, cache32 = _ref_prefill(p32, cfg, jnp.asarray(toks), 20, chunk_q=4)
    want, ref_cache = _ref_prefill(params, cfg, jnp.asarray(toks), 20, use_flash=True,
                                   cache_dtype=jnp.bfloat16)
    got, cache = tf.prefill(model, pcfg, _t(toks), 20, use_flash=True,
                            cache_dtype=torch.bfloat16)
    assert cache["moe_stack"]["c"].dtype == torch.bfloat16

    def far(x, truth):
        x = np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)
        assert np.isfinite(x).all() and x.shape == truth.shape
        return np.abs(x - truth).max() / np.abs(truth).max()

    exact = np.asarray(exact)
    assert far(got, exact) <= 2 * far(want, exact)
    tok = np.asarray(jnp.argmax(exact, -1))[:, None].astype(np.int32)
    exact, _ = _ref_decode(p32, cfg, cache32, jnp.asarray(tok), jnp.int32(11))
    want, _ = _ref_decode(params, cfg, ref_cache, jnp.asarray(tok), jnp.int32(11))
    got, _ = tf.decode_step(model, pcfg, cache, _t(tok), 11)
    exact = np.asarray(exact)
    assert far(got, exact) <= 2 * far(want, exact)
