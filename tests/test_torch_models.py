"""The port's decoder LM against the reference, module by module, at the
smoke configs of Yi-6B, Granite-8B and Nemotron-4 (relu2).

Weights are the reference's ``init_params`` pytree carried across by
``repro_torch.convert.lm_params_from_numpy``; inputs are made with numpy
from a seed and fed to both packages. Everything is compared at
rtol = atol = 2e-4, the tolerance of tests/test_lm_smoke.py. With
``use_flash=True`` the reference runs its Pallas kernel in interpret mode
and the port K6's plain version (these tensors lie on the CPU); the CUDA
kernel is held against the same plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import chunked_attention as ref_ca  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.serve.serve_loop import LMServer as RefLMServer  # noqa: E402
from repro.serve.serve_loop import ServeConfig as RefServeConfig  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.models import attention, layers  # noqa: E402
from repro_torch.models import chunked_attention as ca  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve import LMServer, ServeConfig  # noqa: E402

ARCHS = ["yi_6b", "granite_8b", "nemotron_4_15b"]
TOL = dict(rtol=2e-4, atol=2e-4)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    """(reference cfg, reference params, port cfg, port model) of one arch."""
    cfg = ref_get_smoke(request.param)
    params = ref_tf.init_params(jax.random.PRNGKey(0), cfg)
    pcfg = get_smoke(request.param)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), pcfg, device="cpu")
    return cfg, params, pcfg, model


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


# --------------------------------------------------------------------------
# Configs
# --------------------------------------------------------------------------
DEEPSEEK = ["deepseek_v2_lite_16b", "deepseek_v2_236b"]


@pytest.mark.parametrize("arch", ARCHS + DEEPSEEK + ["autoint"])
def test_configs_are_copies_of_the_reference(arch):
    for port, ref in ((get_config(arch), ref_get_config(arch)),
                      (get_smoke(arch), ref_get_smoke(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("arch", ARCHS + DEEPSEEK)
def test_param_counts_equal_the_reference(arch):
    """The port's ``n_params`` / ``n_active_params`` count as the
    reference's, MLA and MoE branches included (DeepSeek-V2-Lite
    15,706,470,400 and DeepSeek-V2 235,741,312,000 in all)."""
    ref, port = ref_get_config(arch), get_config(arch)
    assert port.n_params() == ref.n_params()
    assert port.n_active_params() == ref.n_active_params()
    assert port.hd == ref.hd


def test_archs_the_port_does_not_run_name_their_roadmap_item():
    """Every reference architecture loads in the port (the GNNs since
    ROADMAP.md item 6c-i, ``triangle`` since 6f: its config and smoke
    config equal the reference's field for field), the list ends as the
    reference's does; an unknown name still raises, naming what the port
    has."""
    from repro.configs import ARCHS as REF_ARCHS
    from repro_torch.configs import ARCHS as PORT_ARCHS

    for arch in REF_ARCHS:
        assert get_config(arch).name and get_smoke(arch).name
    assert sorted(PORT_ARCHS) == sorted(REF_ARCHS) and PORT_ARCHS[-1] == REF_ARCHS[-1]
    for port, ref in ((get_config("triangle"), ref_get_config("triangle")),
                      (get_smoke("triangle"), ref_get_smoke("triangle"))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for arch in ("no_such_arch",):
        with pytest.raises(KeyError, match="not in the port"):
            get_config(arch)


def test_models_need_a_card_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke("yi_6b")
    for make in (lambda: tf.Transformer(cfg), lambda: tf.cache_init(cfg, 1, 4),
                 lambda: attention.gqa_cache_init(cfg, 1, 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert tf.Transformer(cfg, device="cpu").device.type == "cpu"


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------
def test_rms_norm_rotary_and_mlp_match_reference(lm):
    cfg, params, pcfg, model = lm
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    scale = rng.standard_normal(cfg.d_model).astype(np.float32)
    _close(layers.rms_norm(_t(x), _t(scale), cfg.norm_eps),
           ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale), cfg.norm_eps))
    pos = np.array([0, 3, 7, 100, 4095], np.int32)
    for got, want in zip(layers.rotary_cos_sin(_t(pos), cfg.hd, 5e6),
                         ref_layers.rotary_cos_sin(jnp.asarray(pos), cfg.hd, 5e6)):
        _close(got, want)
    xh = rng.standard_normal((2, 3, 5, cfg.hd)).astype(np.float32)
    cos, sin = ref_layers.rotary_cos_sin(jnp.arange(5), cfg.hd, cfg.rope_theta)
    _close(layers.apply_rotary(_t(xh), _t(cos), _t(sin)),
           ref_layers.apply_rotary(jnp.asarray(xh), cos, sin))
    mlp_ref = jax.tree.map(lambda a: a[0], params["dense"]["mlp"])
    _close(layers.mlp_apply(model.layers[0].mlp, _t(x), cfg.act),
           ref_layers.mlp_apply(mlp_ref, jnp.asarray(x), cfg.act))


@pytest.mark.parametrize("act", ["swiglu", "geglu", "relu2"])
def test_activations_match_reference(act):
    x = np.linspace(-4, 4, 101).astype(np.float32)
    _close(layers.activation(act)(_t(x)), ref_layers.activation(act)(jnp.asarray(x)))


def test_mlp_init_draws_from_the_generator_at_fan_in_scale():
    a = layers.mlp_init(torch.Generator().manual_seed(3), 256, 512, "swiglu", device="cpu")
    b = layers.mlp_init(torch.Generator().manual_seed(3), 256, 512, "swiglu", device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert abs(float(a.w_gate.std()) - 256**-0.5) < 0.01 * 256**-0.5 * 5
    assert abs(float(a.w_down.std()) - 512**-0.5) < 0.01 * 512**-0.5 * 5
    assert set(dict(layers.mlp_init(torch.Generator(), 8, 16, "relu2", device="cpu")
                    .named_parameters())) == {"w_in", "w_out"}


# --------------------------------------------------------------------------
# Attention (every GQA case has Hkv < Hq)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("hq,hkv,s,chunk", [(4, 2, 19, 8), (8, 1, 16, 16), (4, 1, 33, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_matches_reference(hq, hkv, s, chunk, causal):
    rng = np.random.default_rng(hq * s)
    q = rng.standard_normal((2, hq, s, 16)).astype(np.float32)
    k = rng.standard_normal((2, hkv, s, 16)).astype(np.float32)
    v = rng.standard_normal((2, hkv, s, 24)).astype(np.float32)
    want = ref_ca.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=causal, chunk_q=chunk)
    _close(ca.chunked_attention(_t(q), _t(k), _t(v), causal=causal, chunk_q=chunk), want)


@pytest.mark.parametrize("cur_len", [1, 5, 12])
def test_decode_attention_matches_reference(cur_len):
    rng = np.random.default_rng(cur_len)
    q = rng.standard_normal((3, 8, 16)).astype(np.float32)
    kc = rng.standard_normal((3, 2, 12, 16)).astype(np.float32)
    vc = rng.standard_normal((3, 2, 12, 16)).astype(np.float32)
    want = ref_ca.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                   jnp.int32(cur_len))
    _close(ca.decode_attention(_t(q), _t(kc), _t(vc), cur_len), want)
    _close(ca.decode_attention(_t(q), _t(kc), _t(vc), torch.tensor(cur_len)), want)


@pytest.mark.parametrize("use_flash", [False, True])
def test_gqa_full_matches_reference(lm, use_flash):
    cfg, params, pcfg, model = lm
    assert cfg.n_kv_heads < cfg.n_heads
    x = np.random.default_rng(2).standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    cos, sin = ref_layers.rotary_cos_sin(jnp.arange(12), cfg.hd, cfg.rope_theta)
    p_ref = jax.tree.map(lambda a: a[1], params["dense"]["attn"])
    want = ref_attn.gqa_full(p_ref, cfg, jnp.asarray(x), cos, sin, use_flash=use_flash,
                             chunk_q=8)
    got = attention.gqa_full(model.layers[1].attn, pcfg, _t(x), _t(cos), _t(sin),
                             use_flash=use_flash, chunk_q=8)
    _close(got, want)


def test_gqa_cache_fill_and_decode_match_reference(lm):
    cfg, params, pcfg, model = lm
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    cos, sin = ref_layers.rotary_cos_sin(jnp.arange(7), cfg.hd, cfg.rope_theta)
    p_ref = jax.tree.map(lambda a: a[0], params["dense"]["attn"])
    p = model.layers[0].attn
    ref_cache = ref_attn.gqa_prefill_cache(p_ref, cfg, jnp.asarray(x), cos, sin,
                                           ref_attn.gqa_cache_init(cfg, 2, 10, jnp.float32))
    cache = attention.gqa_cache_init(pcfg, 2, 10, device="cpu")
    assert attention.gqa_prefill_cache(p, pcfg, _t(x), _t(cos), _t(sin), cache) is cache
    for name in ("k", "v"):
        _close(cache[name], ref_cache[name])
    xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    c1, s1 = ref_layers.rotary_cos_sin(jnp.array([7]), cfg.hd, cfg.rope_theta)
    y_ref, ref_cache = ref_attn.gqa_decode(p_ref, cfg, jnp.asarray(xt), c1, s1, ref_cache,
                                           jnp.int32(7))
    y, out = attention.gqa_decode(p, pcfg, _t(xt), _t(c1), _t(s1), cache, 7)
    assert out is cache
    _close(y, y_ref)
    for name in ("k", "v"):
        _close(cache[name], ref_cache[name])


# --------------------------------------------------------------------------
# The model
# --------------------------------------------------------------------------
@pytest.mark.parametrize("use_flash", [False, True])
def test_forward_matches_reference(lm, use_flash):
    cfg, params, pcfg, model = lm
    toks = _tokens(cfg, (2, 16), 5)
    want, _ = ref_tf.forward(params, cfg, jnp.asarray(toks), use_flash=use_flash, chunk_q=8)
    got, aux = tf.forward(model, pcfg, _t(toks), use_flash=use_flash, chunk_q=8)
    assert got.dtype == torch.float32 and got.shape == (2, 16, cfg.vocab)
    assert float(aux) == 0.0
    _close(got, want)
    hid, _ = tf.hidden(model, pcfg, _t(toks), chunk_q=8)
    want_h, _ = ref_tf.hidden(params, cfg, jnp.asarray(toks), chunk_q=8)
    _close(hid, want_h)


@pytest.mark.parametrize("use_flash", [False, True])
def test_prefill_matches_reference(lm, use_flash):
    """Last-token logits and every cache entry: both layers, k and v, all
    s_max positions (the unfilled tail stays 0)."""
    cfg, params, pcfg, model = lm
    toks = _tokens(cfg, (2, 11), 6)
    want, ref_cache = ref_tf.prefill(params, cfg, jnp.asarray(toks), 20,
                                     use_flash=use_flash, chunk_q=4)
    got, cache = tf.prefill(model, pcfg, _t(toks), 20, use_flash=use_flash, chunk_q=4)
    _close(got, want)
    assert set(cache) == set(ref_cache) == {"dense"}
    for name in ("k", "v"):
        assert cache["dense"][name].shape == ref_cache["dense"][name].shape
        _close(cache["dense"][name], ref_cache["dense"][name])


def test_decode_step_matches_reference_and_writes_the_cache_in_place(lm):
    """Deliberate difference: the port's decode_step writes the given cache
    in place and returns that same cache; the reference returns a copy."""
    cfg, params, pcfg, model = lm
    toks = _tokens(cfg, (2, 9), 7)
    _, ref_cache = ref_tf.prefill(params, cfg, jnp.asarray(toks[:, :-1]), 12)
    _, cache = tf.prefill(model, pcfg, _t(toks[:, :-1]), 12)
    before = {name: x.data_ptr() for name, x in cache["dense"].items()}
    tok = toks[:, -1:]
    for step in range(3):
        want, ref_cache = ref_tf.decode_step(params, cfg, ref_cache, jnp.asarray(tok),
                                             jnp.int32(8 + step))
        got, out = tf.decode_step(model, pcfg, cache, _t(tok), 8 + step)
        assert out is cache
        assert {name: x.data_ptr() for name, x in cache["dense"].items()} == before
        _close(got, want)
        tok = np.asarray(jnp.argmax(want, -1))[:, None].astype(np.int32)
    for name in ("k", "v"):
        _close(cache["dense"][name], ref_cache["dense"][name])


def test_decode_step_takes_a_device_position(lm):
    _, _, pcfg, model = lm
    toks = _t(_tokens(pcfg, (1, 6), 8))
    _, c1 = tf.prefill(model, pcfg, toks[:, :-1], 8)
    _, c2 = tf.prefill(model, pcfg, toks[:, :-1], 8)
    a, _ = tf.decode_step(model, pcfg, c1, toks[:, -1:], 5)
    b, _ = tf.decode_step(model, pcfg, c2, toks[:, -1:], torch.tensor(5))
    assert torch.equal(a, b)
    assert torch.equal(c1["dense"]["k"], c2["dense"]["k"])


@pytest.mark.parametrize("use_flash", [False, True])
def test_prefill_then_decode_matches_forward(lm, use_flash):
    _, _, pcfg, model = lm
    toks = _t(_tokens(pcfg, (1, 10), 9))
    full, _ = tf.forward(model, pcfg, toks, use_flash=use_flash, chunk_q=4)
    last, cache = tf.prefill(model, pcfg, toks[:, :-1], 16, use_flash=use_flash, chunk_q=4)
    _close(last, full[:, -2])
    logits, _ = tf.decode_step(model, pcfg, cache, toks[:, -1:], 9)
    _close(logits, full[:, -1])


def test_init_params_is_seeded_and_at_reference_scales():
    cfg = get_smoke("granite_8b")
    a = tf.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    b = tf.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert abs(float(a.embed.std()) - 0.02) < 0.002
    assert abs(float(a.layers[0].attn.wo.std()) - (cfg.n_heads * cfg.hd) ** -0.5) < 0.02
    assert float(a.final_norm.min()) == float(a.layers[1].ln2.max()) == 1.0
    assert sum(p.numel() for p in a.parameters()) == cfg.n_params()
    assert not any(p.requires_grad for p in a.parameters())
    g = attention.gqa_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert (g.wq.shape, g.wk.shape, g.wo.shape) == (
        (cfg.d_model, cfg.n_heads * cfg.hd), (cfg.d_model, cfg.n_kv_heads * cfg.hd),
        (cfg.n_heads * cfg.hd, cfg.d_model))
    assert abs(float(g.wq.std()) - cfg.d_model**-0.5) < 0.02


def test_lm_params_from_numpy_raises_on_a_missing_or_misshaped_leaf(lm):
    cfg, params, pcfg, _ = lm
    tree = jax.tree.map(np.asarray, params)
    missing = dict(tree, dense=dict(tree["dense"], attn={
        k: v for k, v in tree["dense"]["attn"].items() if k != "wk"}))
    with pytest.raises(KeyError, match="dense.attn.wk"):
        lm_params_from_numpy(missing, pcfg, device="cpu")
    bad = dict(tree, unembed=tree["unembed"][:, :-1])
    with pytest.raises(ValueError, match="unembed"):
        lm_params_from_numpy(bad, pcfg, device="cpu")
    short = jax.tree.map(lambda a: a[:1], tree["dense"])
    with pytest.raises(ValueError, match="layers"):
        lm_params_from_numpy(dict(tree, dense=short), pcfg, device="cpu")


def test_flash_prefill_on_the_cpu_launches_nothing(lm):
    _, _, pcfg, model = lm
    before = launch_counts()
    tf.prefill(model, pcfg, _t(_tokens(pcfg, (1, 5), 10)), 8, use_flash=True)
    assert launch_counts() == before


# --------------------------------------------------------------------------
# The model in bf16 (the configuration chip_smoke.py serves Yi-6B in)
# --------------------------------------------------------------------------
BF16_REL = 2e-2  # of the largest |value|: bf16 keeps 8 significant bits, and
# XLA's and PyTorch's CPU products round at different places over the layers


@pytest.fixture(scope="module", params=ARCHS)
def lm_bf16(request):
    """(reference cfg, reference bf16 params, port cfg, port bf16 model):
    the reference's ``init_params(dtype=bfloat16)`` carried across exactly
    (every bf16 value is an f32 value) into a bf16 ``Transformer`` whose
    norm scales stay float32, as the reference's do."""
    cfg = ref_get_smoke(request.param)
    params = ref_tf.init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.bfloat16)
    pcfg = get_smoke(request.param)
    f32 = lm_params_from_numpy(jax.tree.map(np.asarray, params), pcfg, device="cpu")
    model = tf.Transformer(pcfg, torch.bfloat16, device="cpu")
    model.load_state_dict(f32.state_dict())
    return cfg, params, pcfg, model


def _close_rel(got, want, rel=BF16_REL):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert np.isfinite(got).all() and got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def test_bf16_flash_prefill_and_decode_match_reference(lm_bf16):
    """prefill(use_flash=True) with a bf16 cache (the reference's Pallas
    kernel in interpret mode, K6's plain version here), then one
    decode_step: logits and every cache entry within 2e-2 of the largest."""
    cfg, params, pcfg, model = lm_bf16
    assert model.embed.dtype == torch.bfloat16 and model.layers[0].ln1.dtype == torch.float32
    toks = _tokens(cfg, (2, 11), 6)
    want, ref_cache = ref_tf.prefill(params, cfg, jnp.asarray(toks), 20, use_flash=True,
                                     cache_dtype=jnp.bfloat16)
    got, cache = tf.prefill(model, pcfg, _t(toks), 20, use_flash=True,
                            cache_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    _close_rel(got, want)
    for name in ("k", "v"):
        assert cache["dense"][name].dtype == torch.bfloat16
        _close_rel(cache["dense"][name], ref_cache["dense"][name].astype(jnp.float32))
    tok = np.asarray(jnp.argmax(want, -1))[:, None].astype(np.int32)
    want, _ = ref_tf.decode_step(params, cfg, ref_cache, jnp.asarray(tok), jnp.int32(11))
    got, _ = tf.decode_step(model, pcfg, cache, _t(tok), 11)
    _close_rel(got, want)


# --------------------------------------------------------------------------
# The server
# --------------------------------------------------------------------------
@pytest.mark.parametrize("lengths", [(6, 6, 6), (3, 9, 5, 7)], ids=["equal", "mixed"])
def test_lm_server_generates_the_reference_tokens(lm, lengths):
    """Same left padding (no pad mask, as in the reference), same chunk_q,
    same greedy decode: the token ids must be equal."""
    cfg, params, pcfg, model = lm
    rng = np.random.default_rng(sum(lengths))
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32) for n in lengths]
    scfg = dict(max_batch=2, max_new_tokens=5)
    want = RefLMServer(params, cfg, RefServeConfig(**scfg)).generate(prompts)
    got = LMServer(model, pcfg, ServeConfig(**scfg)).generate(prompts)
    assert len(got) == len(want) == len(prompts)
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.shape == (5,)
        np.testing.assert_array_equal(g, np.asarray(w))
