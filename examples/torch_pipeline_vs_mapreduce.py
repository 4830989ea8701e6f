"""The paper's headline experiment in miniature, on the PyTorch port: on a
dense graph the dynamic pipeline beats MapReduce by orders of magnitude
because MapReduce's Round-I 2-path materialization scales with Σ deg² (the
replication factor). The planner encodes exactly this, and its chosen plan
is printed per row. The card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_pipeline_vs_mapreduce.py [--device cpu] [--n 1000]
"""
import argparse
import time

from repro_torch.api import GraphStats, TriangleCounter, plan
from repro_torch.core.triangle_mapreduce import (
    count_triangles_mapreduce,
    mapreduce_replication_factor,
)
from repro_torch.graphs import generators as gen

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--n", type=int, default=1000)  # the DSJC family's size
args = ap.parse_args()

counter = TriangleCounter(device=args.device)
for density in (0.1, 0.5, 0.9):
    g = gen.gnp(args.n, density, seed=1)
    rf = mapreduce_replication_factor(g)
    p = plan(GraphStats.from_graph(g), counter.resources)

    t0 = time.perf_counter()
    d = counter.count(g, plan=p).item()
    t_pipe = time.perf_counter() - t0

    t0 = time.perf_counter()
    m = count_triangles_mapreduce(g, device=args.device)
    t_mr = time.perf_counter() - t0
    assert d == m, (d, m)
    print(f"density {density:.1f}: Δ={d:>12d}  {p.method:6s} {t_pipe:6.2f}s  "
          f"mapreduce {t_mr:6.2f}s  (speedup {t_mr / t_pipe:5.1f}x, RF={rf:.2e})")
