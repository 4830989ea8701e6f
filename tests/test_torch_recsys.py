"""The port's recsys path against the reference: the multi-hot embedding
layer (K7's caller) and AutoInt, at ``autoint.smoke_config()``.

Weights are the reference's ``init_params`` pytree carried across by
``repro_torch.convert.recsys_params_from_numpy``; ids and candidates are
made with numpy from a seed. Compared at rtol = atol = 1e-5. With
``use_kernel=True`` the reference runs its Pallas EmbeddingBag in interpret
mode and the port K7's plain version (these tensors lie on the CPU)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.models.gnn import common as ref_common  # noqa: E402
from repro.models.recsys import autoint as ref_autoint  # noqa: E402
from repro.models.recsys import embedding as ref_emb  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.convert import recsys_params_from_numpy  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.models.gnn import common  # noqa: E402
from repro_torch.models.recsys import autoint, embedding  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def rec():
    cfg = ref_get_smoke("autoint")
    params = ref_autoint.init_params(jax.random.PRNGKey(0), cfg)
    pcfg = get_smoke("autoint")
    model = recsys_params_from_numpy(jax.tree.map(np.asarray, params), pcfg, device="cpu")
    return cfg, params, pcfg, model


def _ids(cfg, b, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_per_field,
                                                (b, cfg.n_sparse)).astype(np.int32)


def _bags(cfg, b, l, seed):
    rng = np.random.default_rng(seed)
    bags = rng.integers(0, cfg.vocab_per_field, (b, cfg.n_sparse, l)).astype(np.int32)
    pad = rng.random(bags.shape) < 0.3
    bags[pad] = cfg.vocab_per_field + rng.integers(0, 5, int(pad.sum()))  # any id >= vpf
    bags[0, 0] = cfg.vocab_per_field          # an all-padding bag
    bags[0, 1, 0] = cfg.vocab_per_field - 1   # the last id of a field
    return bags


def test_table_shape_and_offsets_match_reference(rec):
    cfg, _, pcfg, _ = rec
    assert embedding.table_shape(pcfg) == ref_emb.table_shape(cfg)
    assert embedding.table_shape(get_config("autoint")) == (3_900_000, 16)
    np.testing.assert_array_equal(embedding.field_offsets(pcfg, device="cpu").numpy(),
                                  np.asarray(ref_emb.field_offsets(cfg)))


def test_lookup_matches_reference(rec):
    cfg, params, pcfg, model = rec
    ids = _ids(cfg, 6, 1)
    _close(embedding.lookup(model.table, pcfg, _t(ids)),
           ref_emb.lookup(params["table"], cfg, jnp.asarray(ids)))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("l", [1, 4, 7])
def test_lookup_multihot_matches_reference(rec, use_kernel, l):
    cfg, params, pcfg, model = rec
    bags = _bags(cfg, 5, l, l)
    want = ref_emb.lookup_multihot(params["table"], cfg, jnp.asarray(bags),
                                   use_kernel=use_kernel)
    got = embedding.lookup_multihot(model.table, pcfg, _t(bags), use_kernel=use_kernel)
    assert got.shape == (5, cfg.n_sparse, cfg.embed_dim)
    _close(got, want)
    assert float(got[0, 0].abs().max()) == 0.0  # the all-padding bag


def test_lookup_multihot_on_the_cpu_launches_nothing(rec):
    cfg, _, pcfg, model = rec
    before = launch_counts()
    embedding.lookup_multihot(model.table, pcfg, _t(_bags(cfg, 2, 3, 0)), use_kernel=True)
    assert launch_counts() == before


def test_user_repr_ctr_logits_and_retrieval_match_reference(rec):
    cfg, params, pcfg, model = rec
    ids = _ids(cfg, 9, 2)
    _close(autoint.user_repr(model, pcfg, _t(ids)),
           ref_autoint.user_repr(params, cfg, jnp.asarray(ids)))
    got = autoint.ctr_logits(model, pcfg, _t(ids))
    assert got.shape == (9,)
    _close(got, ref_autoint.ctr_logits(params, cfg, jnp.asarray(ids)))
    cands = np.random.default_rng(3).standard_normal((40, cfg.embed_dim)).astype(np.float32)
    got = autoint.retrieval_scores(model, pcfg, _t(ids[:1]), _t(cands))
    assert got.shape == (1, 40)
    _close(got, ref_autoint.retrieval_scores(params, cfg, jnp.asarray(ids[:1]),
                                             jnp.asarray(cands)))


def test_interact_matches_reference(rec):
    cfg, params, pcfg, model = rec
    e = np.random.default_rng(4).standard_normal((3, cfg.n_sparse, cfg.embed_dim))
    e = e.astype(np.float32)
    _close(autoint._interact(model.attn, _t(e), pcfg.n_heads, pcfg.d_attn),
           ref_autoint._interact(params["attn"], jnp.asarray(e), cfg.n_heads, cfg.d_attn))


@pytest.mark.parametrize("final_act", [False, True])
def test_dense_mlp_matches_reference(final_act):
    p = ref_common.mlp_init(jax.random.PRNGKey(5), [12, 20, 7])
    p = jax.tree.map(lambda a: a + 0.1, p)  # non-zero biases
    port = common.DenseMLP([12, 20, 7], device="cpu")
    for name, param in port.named_parameters():
        param.copy_(_t(p[name]))
    x = np.random.default_rng(6).standard_normal((4, 12)).astype(np.float32)
    _close(common.mlp_apply(port, _t(x), act=torch.relu, final_act=final_act),
           ref_common.mlp_apply(p, jnp.asarray(x), act=jax.nn.relu, final_act=final_act))


def test_init_params_is_seeded_and_at_reference_scales(rec):
    _, _, pcfg, _ = rec
    a = autoint.init_params(torch.Generator().manual_seed(1), pcfg, device="cpu")
    b = autoint.init_params(torch.Generator().manual_seed(1), pcfg, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert abs(float(a.table.std()) - 0.01) < 0.001
    assert float(a.head.b0.abs().max()) == 0.0
    assert abs(float(a.head.w0.std()) - a.head.w0.shape[0] ** -0.5) < 0.002
    assert not any(p.requires_grad for p in a.parameters())
    t = embedding.init_table(torch.Generator().manual_seed(1), pcfg, device="cpu")
    assert t.shape == embedding.table_shape(pcfg) and abs(float(t.std()) - 0.01) < 0.001
    m = common.mlp_init(torch.Generator().manual_seed(1), [300, 20, 7], device="cpu")
    assert not m.b0.any() and not m.b1.any() and m.w1.shape == (20, 7)
    assert abs(float(m.w0.std()) - 300**-0.5) < 0.005


def test_recsys_params_from_numpy_raises_on_a_missing_or_misshaped_leaf(rec):
    _, params, pcfg, _ = rec
    tree = jax.tree.map(np.asarray, params)
    with pytest.raises(KeyError, match="cand_proj.b0"):
        recsys_params_from_numpy(dict(tree, cand_proj={"w0": tree["cand_proj"]["w0"]}),
                                 pcfg, device="cpu")
    with pytest.raises(ValueError, match="table"):
        recsys_params_from_numpy(dict(tree, table=tree["table"][:-1]), pcfg, device="cpu")
    with pytest.raises(ValueError, match="attention layers"):
        recsys_params_from_numpy(dict(tree, attn=tree["attn"][:1]), pcfg, device="cpu")
