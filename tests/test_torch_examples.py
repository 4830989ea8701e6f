"""The port's examples (``examples/torch_*.py``) on the CPU, and the four
small names the port adds beside the reference's: the deprecated
``core/triangle_pipeline.count_triangles`` shim, the kernels' launch counts
``triangle_count_grid_steps`` and ``bitset_grid_steps``, ``utils.bytes_of``
and ``train/steps.lm_loss_remat``.

Each example runs in this process (``runpy``, its arguments in
``sys.argv``) under ``--device cpu`` at a small size, and its printed
counts are held against the reference's oracle on the same seeded graph
(exact integers). The small names are held against the reference's where
one applies: counts and bytes exactly, ``lm_loss_remat`` within the LM
train tests' loss bound (rtol 1e-5)."""
import os
import re
import runpy
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.core import triangle_pipeline as ref_tp  # noqa: E402
from repro.core.triangle_ref import count_triangles_brute as ref_brute  # noqa: E402
from repro.graphs import generators as ref_gen  # noqa: E402
from repro.kernels.bitset_count import ops as ref_bitset_ops  # noqa: E402
from repro.kernels.triangle_count import ops as ref_tc_ops  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
from repro import utils as ref_utils  # noqa: E402
from repro_torch import utils  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.core import triangle_pipeline as tp  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402
from repro_torch.kernels.bitset_count import ops as bitset_ops  # noqa: E402
from repro_torch.kernels.triangle_count import ops as tc_ops  # noqa: E402
from repro_torch.train import steps  # noqa: E402

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "examples")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's small tensors: the suite runs
    several workers at once, and torch's default of a thread per core
    oversubscribes the host (a MACE case took 245 s that way, 1 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(name, *args, monkeypatch, capsys) -> str:
    monkeypatch.setattr(sys, "argv", [name, "--device", "cpu", *args])
    runpy.run_path(os.path.join(EXAMPLES, name), run_name="__main__")
    return capsys.readouterr().out


# --------------------------------------------------------------------------
# the examples
# --------------------------------------------------------------------------
def test_torch_quickstart_counts_agree_with_the_reference_oracle(monkeypatch, capsys):
    out = _run("torch_quickstart.py", "--n", "120", monkeypatch=monkeypatch, capsys=capsys)
    want = ref_brute(ref_gen.gnp(120, 0.3, seed=7))
    assert f"every method agrees: {want} triangles" in out
    for method in ("dense", "sparse", "ring", "bitset_ring"):
        assert re.search(rf"pipeline \({method}\s*\):\s+{want}\b", out), method
    assert f"4 concurrent streams:          {[want] * 4}" in out
    small = [ref_brute(ref_gen.gnp(60, 0.3, seed=s)) for s in range(4)]
    assert f"served batch:  {small}" in out


def test_torch_pipeline_vs_mapreduce_counts_each_density(monkeypatch, capsys):
    out = _run("torch_pipeline_vs_mapreduce.py", "--n", "150", monkeypatch=monkeypatch,
               capsys=capsys)
    got = [int(x) for x in re.findall(r"Δ=\s*(\d+)", out)]
    assert got == [ref_brute(ref_gen.gnp(150, d, seed=1)) for d in (0.1, 0.5, 0.9)]


def test_torch_windowed_stream_matches_its_recount_every_epoch(monkeypatch, capsys):
    out = _run("torch_windowed_stream.py", monkeypatch=monkeypatch, capsys=capsys)
    assert len(re.findall(r"epoch +\d+: window count +\d+ == recount", out)) == 12
    assert "!!" not in out
    final = int(re.search(r"final window \(8\.\.11\): (\d+) triangles", out).group(1))
    assert f"count_windowed wrapper: {final} " in out
    assert "ingest traces for all 12 epochs: 1 " in out


def test_torch_serve_lm_decodes_every_prompt(monkeypatch, capsys):
    out = _run("torch_serve_lm.py", monkeypatch=monkeypatch, capsys=capsys)
    assert "prefilled 4×24, decoded 16 tokens each" in out
    rows = re.findall(r"\[\s*((?:\d+\s*)+)\]", out.split("generated token ids:")[1])
    vocab = get_smoke("granite_8b").vocab
    assert len(rows) == 4
    assert all(len(r.split()) == 17 and all(0 <= int(t) < vocab for t in r.split())
               for r in rows)
    # the example exits non-zero unless every step's logits equal one full
    # forward's over the prompt and the decoded tokens
    err, tol = map(float, re.search(r"max abs err ([\d.e+-]+) \(<= ([\d.e+-]+)\)", out).groups())
    assert err <= tol


def test_torch_train_lm_lowers_the_loss(monkeypatch, capsys, tmp_path):
    out = _run("torch_train_lm.py", "--size", "tiny", "--steps", "30", "--batch", "4",
               "--seq", "32", "--ckpt-dir", str(tmp_path), monkeypatch=monkeypatch,
               capsys=capsys)
    first, last = map(float, re.search(r"loss ([\d.]+) → ([\d.]+)", out).groups())
    assert last < first
    assert os.listdir(tmp_path)  # it checkpointed


def test_torch_ring_attention_500k_equals_the_oracle(monkeypatch, capsys):
    out = _run("torch_ring_attention_500k.py", monkeypatch=monkeypatch, capsys=capsys)
    assert out.count("✓") == 2


# --------------------------------------------------------------------------
# the small names
# --------------------------------------------------------------------------
@pytest.mark.parametrize("method", ["dense", "sparse", "mapreduce", "bitset_ring"])
def test_count_triangles_shim_matches_reference(method):
    g = gen.gnp(48, 0.3, seed=3)
    want = ref_tp.count_triangles(ref_gen.gnp(48, 0.3, seed=3), method=method)
    assert tp.count_triangles(g, method=method, device="cpu") == int(want)


@pytest.mark.parametrize("n", [0, 1, 100, 128, 129, 300, 1000, 4472])
def test_triangle_count_grid_steps_counts_the_kernels_ctas(n):
    """The port counts CTAs; the live block triples they cover, summed over
    the work items the kernel decodes, are the reference's grid steps."""
    got = tc_ops.triangle_count_grid_steps(n, sms=132)
    if n == 0:
        assert got == 0
        return
    slice_, items = tc_ops.split_plan(n, n, n, True, 132)
    assert got == items
    chunks = 0
    for i in range(items):
        rb, kb, c0, c1 = tc_ops.work_item(i, n, n, n, True, slice_)
        assert rb <= kb <= c0 < c1
        chunks += c1 - c0
    assert chunks == ref_tc_ops.triangle_count_grid_steps(n) == tc_ops.live_grid_size(
        -(-n // tc_ops.TILE))
    if n <= tc_ops.TILE:
        assert got == ref_tc_ops.triangle_count_grid_steps(n) == 1
    # the split along N follows the card's SM count (an H100 PCIe's 114)
    assert tc_ops.triangle_count_grid_steps(n, sms=114) == tc_ops.split_plan(
        n, n, n, True, 114)[1]


@pytest.mark.parametrize("n_edges", [0, 1, 127, 128, 129, 5000, 200_000, 10_000_000])
def test_bitset_grid_steps_counts_the_kernels_ctas(n_edges):
    """At two words a row a CTA takes 128 edges, the reference's edge tile,
    so the counts agree until the grid's cap of 16 CTAs an SM."""
    got = bitset_ops.bitset_grid_steps(n_edges, n_words=2, sms=132)
    assert got == min(ref_bitset_ops.bitset_grid_steps(n_edges), 16 * 132)
    assert bitset_ops.bitset_grid_steps(n_edges, n_words=1, sms=132) == min(
        -(-n_edges // 256), 16 * 132)
    assert bitset_ops.bitset_grid_steps(n_edges, n_words=1000, sms=114) == min(
        -(-n_edges // 8), 16 * 114)
    assert bitset_ops.bitset_grid_steps(n_edges, n_words=0, sms=132) == 0


def test_bytes_of_matches_reference():
    shapes = {"a": ((3, 5), np.float32), "b": ((7,), np.int64), "c": ((2, 2, 2), np.int32)}
    port = {k: torch.zeros(s, dtype=getattr(torch, np.dtype(d).name)) for k, (s, d) in
            shapes.items()}
    port["d"] = [torch.zeros(4, dtype=torch.bfloat16), np.zeros(3, np.float16), 7, None]
    with jax.enable_x64(True):  # the reference's int64 leaf stays int64
        ref = {k: jnp.zeros(s, d) for k, (s, d) in shapes.items()}
        ref["d"] = [jnp.zeros(4, jnp.bfloat16), np.zeros(3, np.float16), 7, None]
        want = ref_utils.bytes_of(ref)
    assert utils.bytes_of(port) == want == 60 + 56 + 32 + 8 + 6
    assert utils.bytes_of({}) == 0


def test_lm_loss_remat_matches_reference():
    cfg = ref_get_smoke("yi_6b")
    params = jax.jit(ref_tf.init_params, static_argnums=(1,))(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 13)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (2, 13)).astype(np.int32)}
    want = jax.jit(lambda p, b: ref_steps.lm_loss_remat(p, cfg, b, chunk_q=8))(params, batch)
    pcfg = get_smoke("yi_6b")
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), pcfg, device="cpu")
    got = steps.lm_loss_remat(model, pcfg, batch, chunk_q=8)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
