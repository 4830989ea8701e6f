"""The port's ring attention (``repro_torch.models.ring_attention``) against
the reference's and the full-attention oracle, on the sequential stage
chain and on CPU ring meshes of 2, 4 and 8 stages; and the dynamic
pipeline's runtimes on trees of tensors (a tuple resident, a dict stream,
a tuple-of-dict partial), which ring attention needs.

Inputs are made with numpy from a seed and fed to both packages. Attention
is compared at rtol 2e-4, atol 2e-5 (tests/test_ring_attention.py's
tolerance), gradients within 1e-5 of each tensor's largest entry, and the
tree-valued runtimes exactly (their sums are of small integers)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.dynamic_pipeline import FilterSpec as RefFilterSpec  # noqa: E402
from repro.core.dynamic_pipeline import run_sequential as ref_run_sequential  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as ref_attention  # noqa: E402
from repro.models.ring_attention import ring_attention as ref_ring_attention  # noqa: E402
from repro_torch.core import dynamic_pipeline as dp  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.launch import make_ring_mesh  # noqa: E402
from repro_torch.models import ring_attention as ra  # noqa: E402
from repro_torch.models.chunked_attention import chunked_attention  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-5)


def _qkv(b, h, s, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3))


def _t(arrays, **kw):
    return tuple(torch.from_numpy(a).requires_grad_(kw.get("grad", False)) for a in arrays)


def _cpu_mesh(n):
    return make_ring_mesh(n, devices=["cpu"] * n)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("stages,s_mult,seed", [(2, 1, 0), (2, 3, 1), (4, 1, 2), (4, 2, 3),
                                                (8, 1, 4), (8, 4, 5)])
def test_ring_attention_equals_the_reference_and_the_oracle(stages, s_mult, seed, causal):
    """The reference test's shapes (B 1, H 2, D 16, S = stages · 8 · s_mult)."""
    qkv = _qkv(1, 2, stages * 8 * s_mult, 16, seed)
    got = ra.ring_attention(*_t(qkv), n_stages=stages, causal=causal)
    want = ref_ring_attention(*map(jnp.asarray, qkv), n_stages=stages, causal=causal)
    _close(got, want)
    _close(got, ref_attention(*map(jnp.asarray, qkv), causal=causal))
    _close(got, attention_ref(*_t(qkv), causal=causal))


@pytest.mark.parametrize("stages", [2, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_on_a_cpu_mesh_equals_the_chain_and_the_oracle(stages, causal):
    """The reference's real-ring case (B 2, H 2, S 128, D 16) on a CPU mesh
    of ``stages`` stages, against run_sequential and the oracle."""
    qkv = _qkv(2, 2, 128, 16, 3 + stages)
    chain = ra.ring_attention(*_t(qkv), n_stages=stages, causal=causal)
    ring = ra.ring_attention(*_t(qkv), n_stages=stages, causal=causal,
                             mesh=_cpu_mesh(stages))
    _close(ring, chain)
    _close(ring, ref_attention(*map(jnp.asarray, qkv), causal=causal))
    _close(chain, chunked_attention(*_t(qkv), causal=causal, chunk_q=32))


def test_a_mesh_of_one_stage_runs_the_chain_and_a_wrong_width_raises():
    qkv = _t(_qkv(1, 2, 32, 16, 0))
    assert torch.equal(ra.ring_attention(*qkv, n_stages=1, mesh=_cpu_mesh(1)),
                       ra.ring_attention(*qkv, n_stages=1))
    with pytest.raises(ValueError, match="not divisible"):
        ra.ring_attention(*qkv, n_stages=3)
    with pytest.raises(ValueError, match="n_stages"):
        ra.ring_attention(*qkv, n_stages=2, mesh=_cpu_mesh(4))


def test_ring_attention_gradients_match_the_reference():
    qkv = _qkv(1, 2, 32, 16, 9)
    for causal in (True, False):
        q, k, v = _t(qkv, grad=True)
        ra.ring_attention(q, k, v, n_stages=4, causal=causal).square().sum().backward()
        want = jax.grad(lambda a, b, c: jnp.sum(jnp.square(ref_ring_attention(
            a, b, c, n_stages=4, causal=causal))), argnums=(0, 1, 2))(*map(jnp.asarray, qkv))
        for got, w in zip((q, k, v), want):
            w = np.asarray(w)
            assert np.abs(got.grad.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_in_place_and_recorded_paths_agree_bit_for_bit():
    """Without a graph ``process`` works in place; with one, out of place:
    the same arithmetic."""
    qkv = _qkv(1, 2, 64, 16, 11)
    with torch.no_grad():
        quiet = ra.ring_attention(*_t(qkv), n_stages=4)
    recorded = ra.ring_attention(*_t(qkv, grad=True), n_stages=4)
    assert recorded.requires_grad and not quiet.requires_grad
    assert torch.equal(quiet, recorded.detach())


def test_output_keeps_q_dtype():
    q, k, v = (x.to(torch.bfloat16) for x in _t(_qkv(1, 2, 32, 16, 1)))
    out = ra.ring_attention(q, k, v, n_stages=2)
    assert out.dtype == torch.bfloat16
    want = attention_ref(q.float(), k.float(), v.float(), causal=True)
    np.testing.assert_allclose(out.float().numpy(), want.numpy(), rtol=2e-2, atol=2e-2)


def test_spec_is_memoized_so_the_mesh_reuses_one_callable():
    assert ra.ring_attention_spec(8, 4, 16) is ra.ring_attention_spec(8, 4, 16)
    assert ra.ring_attention_spec(8, 4, 16) is not ra.ring_attention_spec(8, 4, 16,
                                                                           causal=False)
    mesh = _cpu_mesh(4)
    qkv = _t(_qkv(1, 2, 32, 16, 2))
    ra.ring_attention(*qkv, n_stages=4, mesh=mesh)
    pipe = dp.mesh_runtime(mesh, "stage").pipeline
    fn = pipe.jit(ra.ring_attention_spec(8, 4, 16))
    ra.ring_attention(*qkv, n_stages=4, mesh=mesh)
    assert pipe.jit(ra.ring_attention_spec(8, 4, 16)) is fn


def test_the_stage_id_stays_a_tensor_on_the_stage():
    spec = ra.ring_attention_spec(4, 2, 16)
    state = spec.init((torch.tensor(1, dtype=torch.int32), torch.zeros(1, 2, 4, 16)))
    state = spec.process(state, (torch.zeros(1, 2, 4, 16), torch.zeros(1, 2, 4, 16)), 0)
    assert isinstance(state["me"], torch.Tensor) and state["me"].dim() == 0
    assert spec.finalize(state).shape == (2, 1, 2, 4, 16)


# ---------------------------------------------------------------------------
# The runtimes on trees of tensors (they took single tensors only)
# ---------------------------------------------------------------------------
def _tree_specs():
    """One filter, in both packages: resident (ids, x) a tuple, stream a dict
    {"a", "b"}, state and partial a (dict, tensor) tuple summed leaf by leaf."""

    def make(np_like, full):
        def init(resident):
            me, x = resident
            return ({"acc": x * 0, "me": me}, full((), 0.0))

        def process(state, blk, src):
            d, n = state
            return ({"acc": d["acc"] + blk["a"] * (d["me"] + 1) + src, "me": d["me"]},
                    n + blk["b"].sum())

        def finalize(state):
            d, n = state
            return ({"acc": d["acc"], "n": n}, d["me"] * 10)

        return init, process, finalize

    port = dp.FilterSpec(*make(torch, lambda s, v: torch.full(s, v)))
    ref = RefFilterSpec(*make(jnp, lambda s, v: jnp.full(s, v)))
    return port, ref


@pytest.mark.parametrize("n_stages", [2, 4, 8])
def test_a_tree_valued_filterspec_runs_on_both_runtimes_as_the_reference(n_stages):
    rng = np.random.default_rng(n_stages)
    ids = np.arange(n_stages, dtype=np.int32)
    x = rng.integers(0, 5, (n_stages, 3)).astype(np.float32)
    stream = {"a": rng.integers(0, 5, (n_stages, 3)).astype(np.float32),
              "b": rng.integers(0, 5, (n_stages, 2, 2)).astype(np.float32)}
    port, ref = _tree_specs()
    want = ref_run_sequential(ref, (jnp.asarray(ids), jnp.asarray(x)),
                              jax.tree.map(jnp.asarray, stream), n_stages)
    resident = (torch.from_numpy(ids), torch.from_numpy(x))
    pstream = {k: torch.from_numpy(v) for k, v in stream.items()}
    chain = dp.run_sequential(port, resident, pstream, n_stages)
    ring = dp.DynamicPipeline(_cpu_mesh(n_stages)).run(port, resident, pstream)
    for got in (chain, ring):
        assert isinstance(got, tuple) and set(got[0]) == {"acc", "n"}
        np.testing.assert_array_equal(got[0]["acc"].numpy(), np.asarray(want[0]["acc"]))
        np.testing.assert_array_equal(got[0]["n"].numpy(), np.asarray(want[0]["n"]))
        assert int(got[1]) == int(want[1]) == 10 * sum(range(n_stages))


def test_stage_streams_send_a_tree():
    mesh = _cpu_mesh(2)
    st = dp.StageStreams(mesh)
    tree = (torch.ones(2), {"k": torch.zeros(3)}, [torch.arange(2)])
    out = st.send(tree, 0, 1)
    assert isinstance(out, tuple) and isinstance(out[1], dict) and isinstance(out[2], list)
    assert torch.equal(out[1]["k"], torch.zeros(3))
