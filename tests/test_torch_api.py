"""The port's counter and server against the reference's: all five count
methods, the batched path, serving, the cache contract, the device rule,
and the import boundary. Every count is compared as an exact integer."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import GraphStats as RefGraphStats  # noqa: E402
from repro.api import Plan as RefPlan  # noqa: E402
from repro.api import Resources as RefResources  # noqa: E402
from repro.api import TriangleCounter as RefTriangleCounter  # noqa: E402
from repro.api import plan as ref_plan  # noqa: E402
from repro.core.triangle_ref import count_triangles_brute  # noqa: E402
from repro.graphs import generators as ref_gen  # noqa: E402
from repro.serve.serve_loop import TriangleServer as RefTriangleServer  # noqa: E402
from repro_torch.api import (  # noqa: E402
    METHODS,
    bucket,
    CountResult,
    GraphStats,
    Plan,
    Resources,
    TriangleCounter,
    count_triangles,
    plan,
)
from repro_torch.convert import graph_from_arrays  # noqa: E402
from repro_torch.core import triangle_pipeline as tp  # noqa: E402
from repro_torch.serve import TriangleServeConfig, TriangleServer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESIDENT = [m for m in METHODS if m != "stream"]


def _port(ref_g):
    return graph_from_arrays(ref_g.n_nodes, ref_g.edges)


@pytest.mark.parametrize("method", RESIDENT)
@pytest.mark.parametrize("n,p,seed", [(40, 0.2, 0), (72, 0.6, 1), (130, 0.1, 2)])
def test_every_method_counts_like_the_reference(method, n, p, seed):
    ref_g = ref_gen.gnp(n, p, seed=seed)
    want = count_triangles_brute(ref_g)
    with jax.enable_x64(True):
        ref_p = ref_plan(RefGraphStats.from_graph(ref_g), RefResources(n_devices=4),
                         allow={method})
    p = plan(GraphStats.from_graph(_port(ref_g)), Resources(n_devices=4), allow={method})
    assert p.to_dict() == ref_p.to_dict() and p.method == method
    ref_res = RefTriangleCounter().count(ref_g, plan=ref_p)
    res = TriangleCounter(device="cpu").count(_port(ref_g), plan=p)
    assert isinstance(res, CountResult) and res.plan is p
    assert isinstance(res.count, torch.Tensor) and res.count.dtype == torch.int64
    assert res.item() == int(res) == ref_res.item() == want
    assert res.stats["cache"]["key"] == ref_res.stats["cache"]["key"]
    if method in ("ring", "bitset_ring"):
        assert res.stats["stage_costs"] == ref_res.stats["stage_costs"]


def test_planner_chosen_counts_match_the_reference():
    graphs = [ref_gen.gnp(60, 0.5, seed=3), ref_gen.powerlaw(150, 3, seed=4),
              ref_gen.road_grid(12, 12, seed=5)]
    c, ref_c = TriangleCounter(Resources(), device="cpu"), RefTriangleCounter()
    for ref_g in graphs:
        with jax.enable_x64(True):
            want = ref_c.count(ref_g)
        got = c.count(_port(ref_g))
        assert got.plan.to_dict() == want.plan.to_dict()
        assert got.item() == want.item() == count_triangles_brute(ref_g)


def test_count_batch_matches_the_reference():
    ref_graphs = [ref_gen.gnp(n, 0.5, seed=n) for n in (20, 33, 47, 12, 64)]
    c, ref_c = TriangleCounter(Resources(), device="cpu"), RefTriangleCounter()
    res, ref_res = c.count_batch([_port(g) for g in ref_graphs]), ref_c.count_batch(ref_graphs)
    assert res.count.shape == (5,) and res.count.dtype == torch.int64
    assert res.count.tolist() == [int(x) for x in np.asarray(ref_res.count)] == \
        [count_triangles_brute(g) for g in ref_graphs]
    assert res.stats["bucket"] == ref_res.stats["bucket"]
    assert res.plan.to_dict() == ref_res.plan.to_dict()
    # a second same-bucket batch hits the cache, as in the reference
    res2 = c.count_batch([_port(ref_gen.gnp(30, 0.4, seed=7))])
    assert res2.stats["cache"]["hit"] is True
    with pytest.raises(ValueError):
        c.count_batch([])
    with pytest.raises(ValueError):
        c.count_batch([_port(ref_graphs[0])], plan=Plan(method="ring"))


def test_dense_paths_count_the_graphs_own_rows_of_the_bucket(monkeypatch):
    """The dense count and the batch build U in the node bucket, which keys
    the cache as in the reference, but hand the kernel only the graph's own
    n rows (the largest graph's in a batch): a view of the bucket, its row
    stride the bucket's. Counts, buckets and cache keys equal the
    reference's."""
    seen = []
    real = tp.count_triangles_dense

    def recorder(u, **kw):
        seen.append((tuple(u.shape), u.stride()))
        return real(u, **kw)

    monkeypatch.setattr(tp, "count_triangles_dense", recorder)
    c, ref_c = TriangleCounter(Resources(), device="cpu"), RefTriangleCounter()
    for n in (1, 40, 64, 65, 100):
        ref_g = ref_gen.gnp(n, 0.5, seed=n)
        res = c.count(_port(ref_g), plan=Plan(method="dense"))
        ref_res = ref_c.count(ref_g, plan=RefPlan(method="dense"))
        n_b = bucket(n)
        assert seen.pop() == ((n, n), (n_b, 1)) and not seen
        assert res.item() == ref_res.item() == count_triangles_brute(ref_g)
        assert res.stats["cache"]["key"] == ref_res.stats["cache"]["key"]
        assert res.stats["cache"]["key"][1] == (n_b,)
    ref_graphs = [ref_gen.gnp(n, 0.5, seed=n) for n in (20, 33, 47, 12)]
    res, ref_res = c.count_batch([_port(g) for g in ref_graphs]), ref_c.count_batch(ref_graphs)
    assert seen.pop() == ((4, 47, 47), (64 * 64, 64, 1)) and not seen
    assert res.count.tolist() == [int(x) for x in np.asarray(ref_res.count)] == \
        [count_triangles_brute(g) for g in ref_graphs]
    assert res.stats["bucket"] == ref_res.stats["bucket"] == (8, 64)
    assert res.stats["cache"]["key"] == ref_res.stats["cache"]["key"]


def test_cache_contract_matches_the_reference():
    c, ref_c = TriangleCounter(Resources(), device="cpu"), RefTriangleCounter()
    for n in (40, 50, 60):  # all pad to the same 64-bucket
        ref_g = ref_gen.gnp(n, 0.5, seed=n)
        res = c.count(_port(ref_g), plan=Plan(method="dense"))
        ref_c.count(ref_g, plan=Plan(method="dense"))
        assert res.item() == count_triangles_brute(ref_g)
    assert c.cache_info == ref_c.cache_info == {"entries": 1, "traces": 1, "hits": 2}
    assert res.stats["cache"]["hit"] is True


@pytest.mark.parametrize("cfg", [None, TriangleServeConfig(max_batch=2, batch_node_limit=64)])
def test_server_answers_like_the_reference(cfg):
    from repro.serve.serve_loop import TriangleServeConfig as RefCfg

    ref_graphs = [ref_gen.gnp(n, 0.5, seed=n) for n in (30, 45, 70, 100, 25)] + \
        [ref_gen.powerlaw(200, 3, seed=1), ref_gen.road_grid(15, 15, seed=2),
         ref_gen.gnp(150, 0.05, seed=3)]
    ref_cfg = None if cfg is None else RefCfg(max_batch=cfg.max_batch,
                                              batch_node_limit=cfg.batch_node_limit)
    with jax.enable_x64(True):
        want = RefTriangleServer(serve_cfg=ref_cfg).serve(ref_graphs)
    got = TriangleServer(Resources(), cfg, device="cpu").serve([_port(g) for g in ref_graphs])
    assert len(got) == len(want)
    for r, w, g in zip(got, want, ref_graphs):
        assert r.plan.to_dict() == w.plan.to_dict()
        assert bool(r.stats.get("batched")) == bool(w.stats.get("batched"))
        assert r.item() == int(np.asarray(w.count)) == count_triangles_brute(g)


def test_count_triangles_front_door():
    ref_g = ref_gen.gnp(50, 0.4, seed=9)
    want = count_triangles_brute(ref_g)
    g = _port(ref_g)
    c = TriangleCounter(Resources(n_devices=4), device="cpu")
    for method in ("auto", "dense", "sparse", "ring", "bitset", "mapreduce"):
        assert count_triangles(g, method=method, counter=c) == want
    assert count_triangles(g, method="ring", n_stages=3, device="cpu") == want
    # the legacy ring kwargs fall through to the ring entry points, as in
    # the reference; on any other method they raise
    assert count_triangles(g, method="ring", mesh=None, counter=c) == want
    with pytest.raises(TypeError):
        count_triangles(g, method="sparse", mesh=None, counter=c)


def test_plan_that_contradicts_the_device_is_refused():
    # on the CPU the port runs the plain versions, never a kernel
    g = _port(ref_gen.gnp(30, 0.4, seed=2))
    c = TriangleCounter(Resources(), device="cpu")
    for flags in ({"use_kernel": True, "interpret": False},
                  {"use_kernel": True, "interpret": True}):
        with pytest.raises(ValueError, match="contradicts device cpu"):
            c.count(g, plan=Plan(method="dense", **flags))
        with pytest.raises(ValueError, match="contradicts device cpu"):
            c.count_batch([g, g], plan=Plan(method="dense", **flags))
    with pytest.raises(ValueError, match="contradicts device cpu"):
        count_triangles(g, method="sparse", use_kernel=True, counter=c)
    # a card's plan (the reference's "tpu" flags) on a CPU counter
    cuda_plan = plan(GraphStats.from_graph(g), Resources(backend="cuda"), allow={"ring"})
    with pytest.raises(ValueError, match="contradicts device cpu"):
        c.count(g, plan=cuda_plan)
    assert c.cache_info == {"entries": 0, "traces": 0, "hits": 0}  # nothing ran
    assert c.count(g, plan=Plan(method="dense")).item() == count_triangles_brute(g)


def test_entry_points_need_a_card_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = _port(ref_gen.gnp(20, 0.5, seed=1))
    for make in (lambda: TriangleCounter(), lambda: TriangleCounter(Resources()),
                 lambda: TriangleServer(), lambda: TriangleServer(Resources()),
                 lambda: Resources.detect(), lambda: TriangleCounter(device="cuda"),
                 lambda: count_triangles(g), lambda: tp.count_triangles_ring(g),
                 lambda: tp.count_triangles_bitset_ring(g)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    c = TriangleCounter(device="cpu")
    assert c.device.type == "cpu" and c.resources.backend == "cpu"
    assert TriangleServer(device="cpu").counter.device.type == "cpu"


def test_import_repro_torch_pulls_in_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.api, repro_torch.serve, repro_torch.convert\n"
        "import repro_torch.core, repro_torch.kernels, repro_torch.graphs.datasets\n"
        "import repro_torch.kernels.triangle_count, repro_torch.kernels.bitset_count\n"
        "import repro_torch.core.streaming, repro_torch.kernels._build\n"
        "import repro_torch.configs, repro_torch.models.layers\n"
        "import repro_torch.models.chunked_attention, repro_torch.models.attention\n"
        "import repro_torch.models.transformer, repro_torch.models.recsys.embedding\n"
        "import repro_torch.models.recsys.autoint, repro_torch.models.gnn.common\n"
        "import repro_torch.kernels.flash_attention, repro_torch.kernels.embedding_bag\n"
        "import repro_torch.models.ring_attention, repro_torch.launch.train\n"
        "import repro_torch.train.optimizer, repro_torch.train.compression\n"
        "import repro_torch.train.checkpoint, repro_torch.train.steps\n"
        "import repro_torch.data.pipeline, repro_torch.graphs.sampler\n"
        "import repro_torch.models.gnn.gin, repro_torch.models.gnn.graphcast\n"
        "import repro_torch.models.gnn.dimenet, repro_torch.models.gnn.mace\n"
        "import repro_torch.models.gnn.cg, repro_torch.configs.shapes\n"
        "import repro_torch.models.gnn.distributed\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.hlo_analysis\n"
        "import repro_torch.launch.analytic, repro_torch.configs.triangle\n"
        "from repro_torch.api import SessionCheckpoint, StreamSession, TriangleCounter\n"
        "from repro_torch.kernels.bitset_count import bitset_pair_count\n"
        "import numpy as np, tempfile, os\n"
        "c = TriangleCounter(device='cpu')\n"
        "e = np.array([[0, 1], [1, 2], [0, 2], [2, 3], [1, 3]], np.int32)\n"
        "s = c.open_stream(4, window=2)\n"
        "s.feed(e[:2]); s.advance(); s.feed(e[2:])\n"
        "ck = s.checkpoint(); ck.spill(os.path.join(tempfile.mkdtemp(), 'c.npz'))\n"
        "ck = SessionCheckpoint.from_file(ck.path)\n"
        "assert c.restore_stream(ck).finalize().item() == 2\n"
        "assert c.count_stream(4, [e]).item() == 2\n"
        "from repro_torch.serve import TriangleServer\n"
        "srv = TriangleServer(device='cpu', prefetch_depth=2)\n"
        "assert [r.item() for r in srv.serve_streams([(4, [e]), (4, [e[:3]])])] == [2, 1]\n"
        "import torch\n"
        "from repro_torch.configs import get_config, get_smoke\n"
        "from repro_torch.models import transformer as tf\n"
        "from repro_torch.models.recsys import autoint, embedding\n"
        "from repro_torch.serve import LMServer, ServeConfig\n"
        "cfg = get_smoke('yi_6b')\n"
        "m = tf.init_params(torch.Generator().manual_seed(0), cfg, device='cpu')\n"
        "out = LMServer(m, cfg, ServeConfig(max_batch=2, max_new_tokens=3)).generate(\n"
        "    [np.arange(1, 5, dtype=np.int32), np.arange(2, 9, dtype=np.int32)])\n"
        "assert [o.shape for o in out] == [(3,), (3,)]\n"
        "tf.prefill(m, cfg, torch.ones(1, 4, dtype=torch.long), 6, use_flash=True)\n"
        "rc = get_smoke('autoint')\n"
        "a = autoint.init_params(torch.Generator().manual_seed(0), rc, device='cpu')\n"
        "assert autoint.ctr_logits(a, rc, torch.zeros(2, 39, dtype=torch.long)).shape == (2,)\n"
        "bags = torch.full((2, 39, 3), 64)\n"
        "assert not embedding.lookup_multihot(a.table, rc, bags, use_kernel=True).any()\n"
        "assert get_config('yi_6b').n_layers == 32\n"
        "from repro_torch.models.gnn import mace\n"
        "from repro_torch.train.steps import make_gnn_train_step\n"
        "from repro_torch.train.optimizer import init_state\n"
        "mc = get_smoke('mace')\n"
        "mm = mace.init_params(torch.Generator().manual_seed(0), mc, device='cpu')\n"
        "pos = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)\n"
        "mb = {'z': np.arange(5), 'pos': pos, 'edges': e, 'target': np.ones(1, np.float32)}\n"
        "make_gnn_train_step(mc)(mm, init_state(mm), mb)\n"
        "from repro_torch.launch import make_ring_mesh\n"
        "from repro_torch.models.gnn import distributed as gd, gin\n"
        "gc = get_smoke('gin_tu')\n"
        "gmod = gin.init_params(torch.Generator().manual_seed(0), gc, 3, device='cpu')\n"
        "pe, _ = gd.partition_edges_by_dst(np.concatenate([e, e[:, ::-1]]), 6, 2)\n"
        "gb = {'x': np.ones((6, 3), np.float32), 'edges': pe, 'labels': np.zeros(6, np.int64)}\n"
        "gd.make_distributed_gnn_train_step(gc, make_ring_mesh(2, devices=['cpu'] * 2))(\n"
        "    gmod, init_state(gmod), gb)\n"
        "from repro_torch.launch import make_local_mesh, sharding\n"
        "from repro_torch.models import moe\n"
        "dc = get_smoke('deepseek_v2_lite_16b')\n"
        "dm = moe.moe_init(torch.Generator().manual_seed(0), dc, device='cpu')\n"
        "y, _ = moe.moe_apply_ep(dm, dc, torch.ones(8, dc.d_model),\n"
        "                        mesh=make_local_mesh(data=2, model=4, devices=['cpu'] * 8))\n"
        "assert y.shape == (8, dc.d_model)\n"
        "assert sharding.P('data', None) == ('data', None)\n"
        "from repro_torch.launch import dryrun\n"
        "from repro_torch.configs.shapes import TRIANGLE_SHAPES\n"
        "cell = dryrun.triangle_cell('triangle', TRIANGLE_SHAPES[0],\n"
        "                            make_local_mesh(data=2, model=4, devices=['meta'] * 8))\n"
        "assert dryrun.count_cell(cell).flops > 0\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "raise SystemExit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_sources_never_import_jax_or_repro():
    """Static twin of the subprocess check: no module of the port, and
    neither chip_smoke.py nor an ``examples/torch_*.py``, names jax or the
    reference package in an import."""
    import ast

    roots = [os.path.join(REPO, "src", "repro_torch")]
    files = [os.path.join(REPO, "chip_smoke.py")]
    files += [os.path.join(REPO, "examples", f) for f in os.listdir(os.path.join(REPO, "examples"))
              if f.startswith("torch_") and f.endswith(".py")]
    for root in roots:
        for d, _, names in os.walk(root):
            files += [os.path.join(d, f) for f in names if f.endswith(".py")]
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for mod in mods:
                assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), (path, mod)
