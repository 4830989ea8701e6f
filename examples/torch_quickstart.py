"""Quickstart of the PyTorch port: planned triangle counting via
``repro_torch.api``, cross-checked against MapReduce and the brute-force
oracle, on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu] [--n 400]
"""
import argparse

from repro_torch.api import GraphStats, Plan, TriangleCounter, backend_exec_flags, plan
from repro_torch.core.triangle_mapreduce import count_triangles_mapreduce
from repro_torch.core.triangle_ref import count_triangles_brute
from repro_torch.graphs import generators as gen
from repro_torch.serve.serve_loop import TriangleServer

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--n", type=int, default=400)
args = ap.parse_args()

graph = gen.gnp(args.n, 0.3, seed=7)
print(f"G(n={graph.n_nodes}, m={graph.n_edges}, density={graph.density:.3f})")

counter = TriangleCounter(device=args.device)
# The planner turns measured input properties into an inspectable Plan.
p = plan(GraphStats.from_graph(graph), counter.resources)
print(f"plan: method={p.method} n_stages={p.n_stages} "
      f"predicted_bytes={p.predicted_bytes} ({p.reason})")

result = counter.count(graph)  # planner-chosen path
oracle = count_triangles_brute(graph)
print(f"oracle (trace A³/6):          {oracle}")
print(f"planned ({result.plan.method}):              {result.item()}  "
      f"[{result.wall_s * 1e3:.1f} ms]")
counts = {"oracle": oracle, "planned": result.item()}

# Any method is still one plan away — same counter.
for method in ("dense", "sparse", "ring", "bitset_ring"):
    r = counter.count(graph, plan=Plan(method=method, n_stages=4,
                                       **backend_exec_flags(counter.resources)))
    counts[method] = r.item()
    print(f"pipeline ({method:11s}):        {r.item()}")
counts["mapreduce"] = count_triangles_mapreduce(graph, device=args.device)
print(f"mapreduce (Suri–Vassilvitskii): {counts['mapreduce']}")

# Streaming: same contract, the graph arrives as edge blocks.
blocks = (graph.edges[i:i + 1024] for i in range(0, graph.n_edges, 1024))
rs = counter.count_stream(graph.n_nodes, blocks)
counts["stream"] = rs.item()
print(f"stream (bitset fold):          {rs.item()}  "
      f"[{rs.stats['n_blocks']} blocks, {rs.stats['ingest_traces']} trace(s)]")

# Sliding window: count over the last E epochs only — deletions via an
# epoch-rotated bitset ring (full tour: examples/torch_windowed_stream.py).
epochs = [[graph.edges[i:i + 1024]] for i in range(0, graph.n_edges, 1024)]
rw = counter.count_windowed(graph.n_nodes, epochs, window=4)
print(f"sliding window (last 4 of {rw.stats['epochs_advanced'] + 1} epochs): "
      f"{rw.item()}  [{rw.stats['n_blocks']} blocks, 1 slot clear per slide]")

# Batched: many small graphs, one call.
small = [gen.gnp(60, 0.3, seed=s) for s in range(4)]
rb = counter.count_batch(small)
print(f"batch of {len(small)}:   {[int(x) for x in rb.count]}")

# Served: batched resident requests + CONCURRENT stream sessions, one server.
# prefetch_depth=2 drives the sessions asynchronously: host re-blocking
# overlaps device ingest, bit-identical to the sync path.
server = TriangleServer(prefetch_depth=2, device=args.device)
served = [r.item() for r in server.serve(small)]
print(f"served batch:  {served}")
streams = [(graph.n_nodes, [graph.edges[i:i + 1024]
                            for i in range(0, graph.n_edges, 1024)])
           for _ in range(4)]
multi = [r.item() for r in server.serve_streams(streams, block_size=1024)]
print(f"4 concurrent streams:          {multi}")
print(f"compile cache: {counter.cache_info}")

assert len(set(counts.values())) == 1, counts
assert served == [int(x) for x in rb.count] and multi == [oracle] * 4
print(f"every method agrees: {oracle} triangles")
