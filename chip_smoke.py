#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``
   (one ``nvcc`` per source, all in parallel) and holds each kernel against
   its plain PyTorch version on the card, as exact integers, at several
   shapes: ragged sizes, phantom edges, and the shapes the main path gives
   it at the paper's full Table-1 sizes. Times each kernel, its plain
   version and, where one exists, a single PyTorch call computing the same
   function (``library_ms``; the port never calls it).
2. Serves the Table-1 graphs at full scale (DSJC.1/.5/.9, FB107, FNA.5, NY),
   the FB107 family scaled to n = 17,199, and 16 small graphs through
   ``TriangleServer(device="cuda").serve``.
3. Forces each of dense, ring, bitset_ring, sparse and mapreduce
   (``Resources(max_stages=4)``) on those large graphs — the paper's
   dynamic pipeline against MapReduce — and requires every method to give
   the same count as every other and as the plain path (the plain PyTorch
   dense count on the card up to n = 16384, a host numpy count beyond).
4. Profiles one planner-chosen count of FNA.5 and of NY with
   ``torch.profiler``: host wall, device busy time, the device's idle share.

Phases 2 and 3 are the main path: every kernel's launch count is set to 0
before them and must be above 0 after them. Any mismatch or exception exits
non-zero. The last three lines are the ``kernels`` JSON line, the card's
name and power limit, and ``{"ok": true, "device": {...}}``. Imports nothing
of JAX and nothing of the reference package ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
TABLE1 = ("DSJC.1", "DSJC.5", "DSJC.9", "FB107", "FNA.5", "NY")
METHODS = ("dense", "ring", "bitset_ring", "sparse", "mapreduce")
# Beside Table 1: the FB107 family (power-law, Facebook-ego-like) scaled to
# n = 17,199 — a graph past the plain dense path's reach (n > 16384) that has
# triangles, so every method's count there is held against the host oracle.
LARGE = ("FB107", 9.0)
LARGE_NAME = "FB107x9"
GRAPHS = TABLE1 + (LARGE_NAME,)
# Methods not run: FNA.5 is complete at full scale, so MapReduce's Round I at
# dmax 4471 needs ~40 GB per node batch, and the sparse path 10M searches of
# 8192 ids; FB107x9's hub (dmax 5074, padded to 8192) puts MapReduce's node
# batch of 256 rows at 256·8192² pairs, past the card's memory.
NOT_RUN = {"FNA.5": {"sparse", "mapreduce"}, LARGE_NAME: {"mapreduce"}}
# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): int8 tensor ops and
# the device memory rate.
PEAK_INT8_OPS = 1.979e15
PEAK_BYTES = 3.35e12
# Issue rates outside the tensor cores, per SM per clock, for compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput): 32-bit integer add and bitwise logic 64, population count 16.
# Times this card's SM count and maximum SM clock, read at run time.
INT32_PER_SM_CLK = 64
POPC_PER_SM_CLK = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, *, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def forward_u(g, n: int, device):
    """Strictly upper triangular uint8 U (n, n) of ``g`` under degree order."""
    import numpy as np
    import torch

    from repro_torch.graphs.formats import degree_order

    rank = degree_order(g)
    ru, rv = rank[g.edges[:, 0]], rank[g.edges[:, 1]]
    lo = torch.from_numpy(np.minimum(ru, rv).astype(np.int64)).to(device)
    hi = torch.from_numpy(np.maximum(ru, rv).astype(np.int64)).to(device)
    u = torch.zeros((n, n), dtype=torch.uint8, device=device)
    u[lo, hi] = 1
    return u


def host_count(g, chunk: int = 1 << 24) -> int:
    """Triangles of ``g`` counted on the host in numpy, by code of its own:
    orient every edge from the lower to the higher (degree, id), pair the
    out-edges of each node into wedges, and look each wedge's closing edge
    up among the sorted edge keys. Wedges go ``chunk`` at a time."""
    import numpy as np

    n = g.n_nodes
    e = g.edges.astype(np.int64)
    deg = np.bincount(e.ravel(), minlength=n)
    rank = np.empty(n, np.int64)
    rank[np.lexsort((np.arange(n), deg))] = np.arange(n)
    a, b = rank[e[:, 0]], rank[e[:, 1]]
    keys = np.unique(np.minimum(a, b) * n + np.maximum(a, b))
    lo, hi = keys // n, keys % n  # rows in order, each row's heads ascending
    row_end = np.searchsorted(lo, lo, side="right")
    later = row_end - np.arange(len(keys)) - 1  # out-edges after each one
    ends = np.cumsum(later)
    total, first = 0, 0
    while first < len(keys):
        last = max(int(np.searchsorted(ends, ends[first] - later[first] + chunk,
                                       side="right")), first + 1)
        cnt = later[first:last]
        src = np.repeat(np.arange(first, last), cnt)
        step = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt) + 1
        wedge = hi[src] * n + hi[src + step]
        pos = np.minimum(np.searchsorted(keys, wedge), len(keys) - 1)
        total += int((keys[pos] == wedge).sum())
        first = last
    return total


def plain_count(g) -> int:
    """The plain path: Σ U⊙(U·U) by the plain PyTorch version on the card
    where U fits (n ≤ 16384), else the host oracle ``host_count``."""
    from repro_torch.kernels.triangle_count.ref import triangle_count_ref

    if g.n_nodes <= 16384:
        return int(triangle_count_ref(forward_u(g, g.n_nodes, DEVICE)))
    return host_count(g)


def int_rates() -> tuple[float, float]:
    """This card's 32-bit integer and population-count issue rates, per
    second: the per-SM rates times its SM count and maximum SM clock."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    log(f"  issue rates from {sms} SMs at a maximum SM clock of {mhz:g} MHz")
    per_s = sms * mhz * 1e6
    return INT32_PER_SM_CLK * per_s, POPC_PER_SM_CLK * per_s


# --------------------------------------------------------------------------
# Phase 1: every kernel against its plain version on the card
# --------------------------------------------------------------------------
def check_kernels(graphs: dict) -> dict:
    import torch

    from repro_torch.api import bucket
    from repro_torch.core.triangle_pipeline import (
        build_bitset_ring_operands,
        build_dense_ring_operands,
    )
    from repro_torch.kernels.bitset_count.ops import bitset_edge_count
    from repro_torch.kernels.bitset_count.ref import bitset_edge_count_ref
    from repro_torch.kernels.triangle_count.ops import masked_matmul_sum, triangle_count
    from repro_torch.kernels.triangle_count.ref import (
        masked_matmul_sum_ref,
        triangle_count_ref,
    )

    gen = torch.Generator(device="cpu").manual_seed(0)
    rows = {}

    def rand01(*shape, p):
        return (torch.rand(*shape, generator=gen) < p).to(torch.uint8).to(DEVICE)

    def agree(name, shape, got, want):
        got, want = [int(x) for x in got.reshape(-1)], [int(x) for x in want.reshape(-1)]
        err = max(abs(a - b) for a, b in zip(got, want))
        log(f"  {name:20s} {str(shape):30s} kernel={got[:4]} plain={want[:4]} "
            f"{'match' if err == 0 else 'MISMATCH'}")
        if err != 0:
            raise AssertionError(f"{name} {shape}: kernel {got} != plain {want}")
        return err

    fna = graphs["FNA.5"]
    n_b = bucket(fna.n_nodes)  # 8192, as the dense path pads it
    # ---- K1: live-grid triangle count ----
    cases = [rand01(n, n, p=0.3).triu(1) for n in (1, 63, 100, 257, 1000)]
    cases += [rand01(16, 512, 512, p=0.5).triu(1), forward_u(fna, n_b, DEVICE)]
    err = 0
    for u in cases:
        err = max(err, agree("triangle_count_live", tuple(u.shape), triangle_count(u),
                             triangle_count_ref(u)))
        err = max(err, agree("  (full-grid K2)", tuple(u.shape),
                             triangle_count(u, live_grid=False), triangle_count_ref(u)))
    u = cases[-1]
    u8 = u.view(torch.int8)
    lib_got = (torch._int_mm(u8, u8) * u).sum()
    agree("  (library _int_mm)", tuple(u.shape), lib_got, triangle_count_ref(u))
    ops = 2 * math.comb(n_b, 3)
    nbytes = n_b * n_b + 8
    rows["triangle_count_live"] = dict(
        shape=[n_b, n_b], max_abs_err=err,
        ms=time_ms(lambda: triangle_count(u), reps=10),
        plain_ms=time_ms(lambda: triangle_count_ref(u), reps=3),
        library_ms=time_ms(lambda: (torch._int_mm(u8, u8) * u).sum(), reps=3),
        bound=(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES))
    del cases, u, u8

    # ---- K2: masked matmul-sum ----
    err = 0
    for (R, K, N) in ((64, 64, 64), (100, 70, 130), (33, 1, 17), (512, 2048, 2048)):
        a, b, m = rand01(R, K, p=0.4), rand01(K, N, p=0.4), rand01(R, N, p=0.5)
        for up in (False, True):
            err = max(err, agree(f"masked_matmul_sum{'(up)' if up else ''}", (R, K, N),
                                 masked_matmul_sum(a, b, m, upper_triangular=up),
                                 masked_matmul_sum_ref(a, b, m, upper_triangular=up)))
    # the ring's own operands: FNA.5 over 4 stages, one (stage, block) visit
    pad_to = bucket(-(-fna.n_nodes // 4), minimum=8)
    part, blocks = build_dense_ring_operands(fna, 4, pad_to=pad_to, device=DEVICE)
    R = part.rows_per_stage
    u_s, u_k = blocks[0], blocks[1]
    cols = u_s[:, R:2 * R]
    err = max(err, agree("masked_matmul_sum", ("ring", R, R, part.n_pad),
                         masked_matmul_sum(cols, u_k, u_s),
                         masked_matmul_sum_ref(cols, u_k, u_s)))
    cols_c = cols.contiguous()
    c8, k8 = cols_c.view(torch.int8), u_k.view(torch.int8)
    ops = 2 * R * R * part.n_pad
    nbytes = R * R + 2 * R * part.n_pad + 8
    rows["masked_matmul_sum"] = dict(
        shape=[R, R, part.n_pad], max_abs_err=err,
        ms=time_ms(lambda: masked_matmul_sum(cols, u_k, u_s), reps=10),
        plain_ms=time_ms(lambda: masked_matmul_sum_ref(cols, u_k, u_s), reps=3),
        library_ms=time_ms(lambda: (torch._int_mm(c8, k8) * u_s).sum(), reps=3),
        bound=(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES))
    del blocks, u_s, u_k, cols, cols_c, c8, k8

    # ---- K3: bitset edge count ----
    err = 0
    for (npad, w, nb) in ((64, 2, 32), (128, 4, 57), (96, 1, 16), (1000, 100, 5000),
                          (4096, 33, 200_001)):
        masks = torch.randint(-2**31, 2**31 - 1, (npad, w), generator=gen,
                              dtype=torch.int64).to(torch.int32).to(DEVICE)
        e = torch.randint(0, npad, (nb, 2), generator=gen, dtype=torch.int32)
        e[torch.rand(nb, generator=gen) < 0.2, 0] = npad + 3  # phantom edges
        e[torch.rand(nb, generator=gen) < 0.1, 1] = npad      # clamped v
        e = e.to(DEVICE)
        err = max(err, agree("bitset_edge_count", (npad, w, nb),
                             bitset_edge_count(masks, e), bitset_edge_count_ref(masks, e)))
    # the bitset ring's own operands: FNA.5 over 4 stages
    edge_block = bucket(-(-fna.n_edges // 4), minimum=128)
    part, masks, edges = build_bitset_ring_operands(
        fna, 4, pad_to=pad_to, edge_block=edge_block, device=DEVICE)
    m0, e1 = masks[0], edges[1]
    err = max(err, agree("bitset_edge_count", ("ring",) + tuple(m0.shape) + tuple(e1.shape),
                         bitset_edge_count(m0, e1), bitset_edge_count_ref(m0, e1)))
    w = m0.shape[1]
    real = int((e1[:, 0] < m0.shape[0]).sum())
    # Operations: per word of every real edge an AND and an add on the
    # integer pipe and a popcount on its own, slower pipe. Bytes: the edge
    # block once, and both W-word rows of every real edge — the table is
    # read only through these gathers (at the memory rate; rows that L2
    # serves could come faster, a rate not measured here).
    int_rate, popc_rate = int_rates()
    words = real * w
    log(f"  bitset_edge_count bound inputs: {real} real edges of {e1.shape[0]}, W={w}")
    nbytes = e1.numel() * 4 + real * 2 * w * 4 + 8
    rows["bitset_edge_count"] = dict(
        shape=list(m0.shape) + list(e1.shape), max_abs_err=err,
        ms=time_ms(lambda: bitset_edge_count(m0, e1), reps=10),
        plain_ms=time_ms(lambda: bitset_edge_count_ref(m0, e1), reps=2),
        library_ms=None,
        bound=(max(2 * words / int_rate, words / popc_rate), nbytes / PEAK_BYTES))
    del masks, edges, m0, e1
    torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------------------
# Phases 2 and 3: the main path
# --------------------------------------------------------------------------
def serve_phase(graphs: dict, small: list) -> None:
    import torch

    from repro_torch.core.triangle_ref import count_triangles_brute
    from repro_torch.kernels import launch_counts
    from repro_torch.serve import TriangleServer

    server = TriangleServer(device=DEVICE)
    names = list(GRAPHS) + [f"small[{i}]" for i in range(len(small))]
    requests = [graphs[n] for n in GRAPHS] + small
    before = launch_counts()["triangle_count_live"]
    t0 = time.perf_counter()
    results = server.serve(requests)
    counts = [r.item() for r in results]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"  served {len(requests)} requests in {wall:.3f} s (host wall, synchronized)")
    dense_calls, batches = 0, set()
    for name, g, r, c in zip(names, requests, results, counts):
        log(f"  {name:10s} n={g.n_nodes:7d} m={g.n_edges:9d} method={r.plan.method:11s} "
            f"stages={r.plan.n_stages} count={c:13d} host_launch_s={r.wall_s:.4f}"
            + (" batched" if r.stats.get("batched") else ""))
        if r.stats.get("batched"):
            batches.add(id(r.stats["cache"]))  # one stats dict per batch call
        else:
            dense_calls += r.plan.method == "dense"
    # every dense count and every batch is exactly one live-grid launch
    k1 = launch_counts()["triangle_count_live"] - before
    if k1 != dense_calls + len(batches):
        raise AssertionError(f"live-grid launches {k1} != {dense_calls} dense counts "
                             f"+ {len(batches)} batches")
    for name, g, c in zip(names[len(GRAPHS):], small, counts[len(GRAPHS):]):
        want = count_triangles_brute(g)
        if c != want:
            raise AssertionError(f"{name}: served {c} != brute {want}")
    graphs["_served"] = dict(zip(GRAPHS, counts[:len(GRAPHS)]))


def comparison_phase(graphs: dict) -> None:
    from repro_torch.api import GraphStats, Resources, TriangleCounter, plan
    from repro_torch.kernels import launch_counts

    res = dataclasses.replace(Resources.detect(DEVICE), max_stages=4)
    counter = TriangleCounter(res, device=DEVICE)
    header = "  graph    " + "".join(f"{m:>24s}" for m in METHODS)
    log(header)
    for name in GRAPHS:
        g = graphs[name]
        stats = GraphStats.from_graph(g)
        t0 = time.perf_counter()
        want = plain_count(g)
        plain_s = time.perf_counter() - t0
        if stats.n_edges == stats.n_nodes * (stats.n_nodes - 1) // 2 \
                and want != math.comb(stats.n_nodes, 3):
            raise AssertionError(f"{name}: plain path {want} != C(n,3) of a complete graph")
        cells = []
        for method in METHODS:
            if method in NOT_RUN.get(name, ()):
                cells.append("not run")
                continue
            p = plan(stats, res, allow={method})
            if p.predicted_bytes > res.memory_bytes:
                cells.append("does not fit")
                continue
            k0 = launch_counts()
            t0 = time.perf_counter()
            c = counter.count(g, plan=p).item()
            dt = time.perf_counter() - t0
            k1 = launch_counts()
            if c != want:
                raise AssertionError(f"{name} {method}: {c} != plain path {want}")
            if method == "dense" and k1["triangle_count_live"] == k0["triangle_count_live"]:
                raise AssertionError(f"{name} dense did not launch the live-grid kernel")
            if method == "ring" and k1["masked_matmul_sum"] - k0["masked_matmul_sum"] \
                    != p.n_stages ** 2:
                raise AssertionError(f"{name} ring did not launch S² masked matmul-sums")
            if method == "bitset_ring" and k1["bitset_edge_count"] \
                    - k0["bitset_edge_count"] != p.n_stages ** 2:
                raise AssertionError(f"{name} bitset_ring did not launch S² edge counts")
            cells.append(f"{dt * 1e3:.1f} ms S={p.n_stages}")
        served = graphs["_served"][name]
        if served != want:
            raise AssertionError(f"{name}: served {served} != plain path {want}")
        log(f"  {name:8s} " + "".join(f"{c:>24s}" for c in cells)
            + f"   count={want} (plain path {plain_s:.2f} s)")


# --------------------------------------------------------------------------
# Phase 4: where the time of one count goes (after the main path's counts)
# --------------------------------------------------------------------------
def profile_phase(graphs: dict) -> None:
    """One planner-chosen count of each of the two largest Table-1 graphs
    under ``torch.profiler``, after a warm-up count: host wall, device busy
    time (every kernel, copy and fill), the device's idle share of the wall,
    and the host and device operations that take the most time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import TriangleCounter

    counter = TriangleCounter(device=DEVICE)
    for name in ("FNA.5", "NY"):
        g = graphs[name]
        p = counter.plan_for(g)
        counter.count(g, plan=p).item()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            c = counter.count(g, plan=p).item()
            wall_ms = (time.perf_counter() - t0) * 1e3
        if c != graphs["_served"][name]:
            raise AssertionError(f"{name}: profiled count {c} != served "
                                 f"{graphs['_served'][name]}")
        # device rows (kernels, copies, fills) carry the device time once; a
        # host op's own device time repeats that of the kernels it launched
        events = prof.key_averages()
        dev_rows = [e for e in events if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in dev_rows) / 1e3
        ops_ms = sum(e.self_cpu_time_total for e in events
                     if e.device_type == DeviceType.CPU) / 1e3
        log(f"  {name:6s} method={p.method} wall={wall_ms:.3f} ms device_busy={busy_ms:.3f} ms "
            f"device_idle_share={1 - busy_ms / wall_ms:.4f} host_in_torch_ops={ops_ms:.3f} ms "
            f"host_outside_torch_ops={wall_ms - ops_ms:.3f} ms")
        top_dev = sorted(dev_rows, key=lambda e: -e.self_device_time_total)[:4]
        top_host = sorted(events, key=lambda e: -e.self_cpu_time_total)[:4]
        log("    device: " + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms "
                                       f"x{e.count}" for e in top_dev))
        log("    host:   " + "; ".join(f"{e.key[:48]} {e.self_cpu_time_total / 1e3:.3f} ms "
                                       f"x{e.count}" for e in top_host))


def main() -> int:
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke.py: src/repro_torch not found — run it from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
              "False) — this smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 3
    from repro_torch.graphs import datasets
    from repro_torch.graphs import generators as gen
    from repro_torch.kernels import _build, kernels, launch_counts, reset_launch_counts

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    logs = _build.build_all(verbose=True)
    log(f"[build] {len(logs)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    graphs = {name: datasets.load(name, scale=1.0) for name in TABLE1}
    graphs[LARGE_NAME] = datasets.load(*LARGE)
    small = [gen.gnp(64 + 28 * i + (i % 3) * 5, 0.3 + 0.02 * i, seed=100 + i)
             for i in range(16)]
    log(f"[graphs] Table-1 at full scale, {LARGE_NAME} and 16 small graphs generated in "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[kernels] each kernel against its plain version on the card (exact integers)")
    rows = check_kernels(graphs)
    log(f"[kernels] done in {time.perf_counter() - t0:.1f} s")

    reset_launch_counts()  # the main path starts here
    t0 = time.perf_counter()
    log(f"[serve] TriangleServer(device='cuda').serve on Table-1, {LARGE_NAME} "
        "and 16 small graphs")
    serve_phase(graphs, small)
    log(f"[serve] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log("[compare] dynamic pipeline vs MapReduce, every method forced "
        "(Resources(max_stages=4)); wall = host + device per count")
    comparison_phase(graphs)
    log(f"[compare] done in {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    launches = launch_counts()  # the main path ends here
    log(f"[main path] kernel launches: {launches}")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    t0 = time.perf_counter()
    log("[profile] one planner-chosen count each, torch.profiler (CPU + CUDA)")
    profile_phase(graphs)
    log(f"[profile] done in {time.perf_counter() - t0:.1f} s")

    out = []
    for name, k in kernels().items():
        r = rows[name]
        ops_ms, bytes_ms = (t * 1e3 for t in r["bound"])
        out.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(str(_build.sources()[k.library]), HERE),
            "replaces": {
                "triangle_count_live": "src/repro/kernels/triangle_count/triangle_count.py:162",
                "masked_matmul_sum": "src/repro/kernels/triangle_count/triangle_count.py:79",
                "bitset_edge_count": "src/repro/kernels/bitset_count/bitset_count.py:139",
            }[name],
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": r["library_ms"],
            "match": r["max_abs_err"] == 0, "kernel_ms": r["ms"], "shape": r["shape"],
        })
        log(f"  bound of {name}: operations {ops_ms:.6f} ms, bytes {bytes_ms:.6f} ms")
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
