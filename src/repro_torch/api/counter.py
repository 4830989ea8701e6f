"""``TriangleCounter`` — the planned execution engine, on one device.

One object owns one device. Operands are padded up to power-of-two
buckets with the phantom convention each path already understands (zero rows
for the dense matmul, sentinel ids >= n_pad for sparse/mapreduce), exactly as
in the reference, so the two packages count alike and record the same cache
key, ``(plan.cache_key(), shape bucket)``. PyTorch runs eagerly and nothing is
compiled, so the counter keeps only the set of keys it has seen:
``cache_info`` has the reference's shape, with one "trace" per key. (A cache
of built programs returns with CUDA graphs; ROADMAP.md.) Every entry point
returns a :class:`CountResult` whose ``count`` stays a device tensor until
``.item()`` — callers that feed the count onward (batch aggregation, the
serve loop) never pay a host sync per call.

The counter runs on ``cuda`` unless it is given ``device="cpu"``; on the
card every count goes through the CUDA kernels, on the CPU through their
plain PyTorch versions. A plan must say so: ``use_kernel=True,
interpret=False`` on the card, ``use_kernel=False`` on the CPU (what
:func:`backend_exec_flags` gives for the device's backend); a plan that
contradicts the device is refused with a ``ValueError``. The streaming entry points (``open_stream``,
``count_stream``, ``count_windowed``, ``restore_stream``) come with the port's
streaming slice (ROADMAP.md, queue A, item 1); until then they, and a
``stream`` plan, raise a ``RuntimeError`` that names that item.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.api.planner import GraphStats, Plan, Resources, backend_exec_flags
from repro_torch.api.planner import plan as plan_fn
from repro_torch.utils import resolve_device

_STREAM_TODO = ("streaming is not ported yet (ROADMAP.md queue A, item 1: "
                "streaming ingest + K4 + sessions)")


def bucket(x: int, minimum: int = 64) -> int:
    """Next power of two >= x (>= minimum) — the shape-bucketing policy."""
    b = minimum
    while b < x:
        b *= 2
    return b


@dataclasses.dataclass
class CountResult:
    """The single result contract for every counting path.

    count:  device tensor (int64) — scalar for ``count``, a vector of
            per-graph counts for ``count_batch``. Stays on device until
            ``.item()`` so hot loops avoid per-call syncs.
    plan:   the executed :class:`Plan` (method, predicted bytes, reason).
    wall_s: host wall time of build+launch (launches are asynchronous: it
            excludes device completion unless the path synchronizes anyway).
    stats:  per-run details — cache key and hit, stage costs for
            ring plans.
    """

    count: Any
    plan: Plan
    wall_s: float
    stats: dict = dataclasses.field(default_factory=dict)

    def item(self) -> int:
        return int(self.count.item())

    def __int__(self) -> int:
        return self.item()


def _forward_adjacency_batch(graphs, n_b: int, device: torch.device) -> torch.Tensor:
    """(len(graphs), n_b, n_b) uint8 strictly upper triangular U per graph,
    under each graph's degree order, built on ``device`` — the reference's
    ``forward_adjacency_dense`` in the top-left corner of a zero block, with
    no host (n_b, n_b) array."""
    from repro_torch.graphs.formats import degree_order

    idx = []
    for i, g in enumerate(graphs):
        rank = degree_order(g)
        ru, rv = rank[g.edges[:, 0]], rank[g.edges[:, 1]]
        idx.append(np.stack([np.full(len(ru), i), np.minimum(ru, rv),
                             np.maximum(ru, rv)]).astype(np.int64))
    idx_t = torch.from_numpy(np.concatenate(idx, axis=1)).to(device)
    u = torch.zeros((len(graphs), n_b, n_b), dtype=torch.uint8, device=device)
    u[idx_t[0], idx_t[1], idx_t[2]] = 1
    return u


class TriangleCounter:
    """The front door: plan (or accept a plan), check it against the device,
    execute, record the cache key.

    ``device`` defaults to ``cuda`` and raises without a card; pass
    ``device="cpu"`` for the plain PyTorch versions. ``resources`` defaults
    to :meth:`Resources.detect` on that device. Ring plans run the
    paper-faithful stage chain on the one device.
    """

    def __init__(self, resources: Resources | None = None, *,
                 plan: Plan | None = None, device=None):
        self.device = resolve_device(device)
        self.resources = resources or Resources.detect(self.device)
        self.fixed_plan = plan
        self._seen: dict[tuple, int] = {}  # cache key -> uses

    # -- planning ----------------------------------------------------------
    def plan_for(self, g, *, allow: set[str] | None = None) -> Plan:
        if self.fixed_plan is not None:
            return self.fixed_plan
        return plan_fn(GraphStats.from_graph(g), self.resources, allow=allow)

    # -- cache bookkeeping -------------------------------------------------
    def _note(self, key: tuple) -> dict:
        """Record one use of ``key``; the ``stats["cache"]`` of that use."""
        hit = key in self._seen
        self._seen[key] = self._seen.get(key, 0) + 1
        return {"key": key, "hit": hit}

    @property
    def cache_info(self) -> dict:
        uses = sum(self._seen.values())
        return {"entries": len(self._seen), "traces": len(self._seen),
                "hits": uses - len(self._seen)}

    def _check_plan(self, p: Plan) -> None:
        """Refuse a plan whose kernel flags contradict the device: on the
        card every count launches the CUDA kernels and on the CPU it runs
        their plain versions, so the plan must say the same."""
        on_card = self.device.type == "cuda"
        if p.use_kernel != on_card or (on_card and p.interpret):
            raise ValueError(
                f"plan (use_kernel={p.use_kernel}, interpret={p.interpret}) contradicts "
                f"device {self.device}: it runs "
                f"{'the CUDA kernels' if on_card else 'the plain versions'}; plan with "
                f"Resources(backend={self.device.type!r}) or Resources.detect()")

    # -- entry points ------------------------------------------------------
    def count(self, g, *, plan: Plan | None = None) -> CountResult:
        """Count triangles in a memory-resident graph.

        Plan resolution order: the ``plan`` argument, else the counter's
        fixed plan, else the planner on ``GraphStats.from_graph(g)`` — every
        execution knob comes from the resolved plan, never from defaults.
        The use is recorded under ``(plan.cache_key(), shape bucket)``
        (``stats["cache"]`` holds the key and whether it was seen before)."""
        p = plan or self.plan_for(g)
        t0 = time.perf_counter()
        executor = getattr(self, f"_run_{p.method}", None)
        if executor is None:
            raise ValueError(f"plan method {p.method!r} not executable here")
        self._check_plan(p)
        count, stats = executor(g, p)
        return CountResult(count=count, plan=p,
                           wall_s=time.perf_counter() - t0, stats=stats)

    # -- streaming entry points: not ported yet ----------------------------
    # They keep the reference's signatures and refuse with a RuntimeError
    # (repro-lint R3 admits only the exception types the cluster protocol
    # re-raises by name in this module; NotImplementedError is not one).
    def open_stream(self, n_nodes: int, *, plan: Plan | None = None,
                    block_size: int | None = None, window: int | None = None):
        raise RuntimeError(f"open_stream: {_STREAM_TODO}")

    def restore_stream(self, ckpt):
        raise RuntimeError(f"restore_stream: {_STREAM_TODO}")

    def count_stream(self, n_nodes: int, blocks, *, plan: Plan | None = None,
                     block_size: int | None = None) -> CountResult:
        raise RuntimeError(f"count_stream: {_STREAM_TODO}")

    def count_windowed(self, n_nodes: int, epochs, *, window: int | None = None,
                       plan: Plan | None = None,
                       block_size: int | None = None) -> CountResult:
        raise RuntimeError(f"count_windowed: {_STREAM_TODO}")

    def _run_stream(self, g, p: Plan):
        raise RuntimeError(f"stream plan: {_STREAM_TODO}")

    def batch_plan(self) -> Plan:
        """The dense plan ``count_batch`` runs when none is given: derived
        from ``self.resources`` so the backend decision carries into batched
        serving instead of silently reverting to the Plan defaults."""
        res = self.resources
        return Plan(method="dense", **backend_exec_flags(res),
                    reason=f"batched dense path ({res.backend} backend)")

    def count_batch(self, graphs: list, *, plan: Plan | None = None) -> CountResult:
        """Batched dense path over many small graphs: ONE live-grid kernel
        launch counts the whole batch. ``count`` is the (len(graphs),)
        per-graph vector.

        Plan resolution: the ``plan`` argument, else :meth:`batch_plan`.
        NOTE: the counter's fixed plan is deliberately NOT consulted — a
        fixed single-graph plan rarely describes a batch; pass ``plan=``
        explicitly to force one. Non-``dense`` plans are rejected. Recorded
        under ``(("batch_dense",) + plan.cache_key(), (batch bucket, node
        bucket))``. Graphs pad to the node bucket; the batch itself is not
        padded, since an eager launch needs no fixed batch shape."""
        if not graphs:
            raise ValueError("empty batch")
        p = plan or self.batch_plan()
        if p.method != "dense":
            raise ValueError(
                f"count_batch is the batched dense path; got a plan with "
                f"method={p.method!r}")
        self._check_plan(p)
        from repro_torch.core.triangle_pipeline import count_triangles_dense

        t0 = time.perf_counter()
        n_b = bucket(max(g.n_nodes for g in graphs))
        b_b = bucket(len(graphs), minimum=8)
        us = _forward_adjacency_batch(graphs, n_b, self.device)
        key = (("batch_dense",) + p.cache_key(), (b_b, n_b))
        counts = count_triangles_dense(us)
        return CountResult(
            count=counts, plan=p, wall_s=time.perf_counter() - t0,
            stats={"cache": self._note(key),
                   "batch_size": len(graphs), "bucket": (b_b, n_b)},
        )

    # -- executors (one per plan method) -----------------------------------
    def _run_dense(self, g, p: Plan):
        from repro_torch.core.triangle_pipeline import count_triangles_dense

        n_b = bucket(g.n_nodes)
        u = _forward_adjacency_batch([g], n_b, self.device)[0]
        return count_triangles_dense(u), {"cache": self._note((p.cache_key(), (n_b,)))}

    def _run_sparse(self, g, p: Plan):
        from repro_torch.core.triangle_pipeline import count_triangles_sparse
        from repro_torch.graphs.formats import degree_order, forward_adjacency_padded

        rank = degree_order(g)
        nbrs, _ = forward_adjacency_padded(g, rank)
        n, md = nbrs.shape
        n_b = bucket(n)
        md_b = bucket(max(md, 1), minimum=8)
        # re-sentinel into bucket space: padding value must equal n_pad = n_b
        nb = np.full((n_b, md_b), n_b, np.int32)
        nb[:n, :md] = np.where(nbrs == n, n_b, nbrs)
        ru = rank[g.edges[:, 0]]
        rv = rank[g.edges[:, 1]]
        edges = np.stack([np.minimum(ru, rv), np.maximum(ru, rv)], axis=1)
        m_b = bucket(max(g.n_edges, 1), minimum=256)
        ed = np.full((m_b, 2), n_b, np.int32)
        ed[: g.n_edges] = edges
        out = count_triangles_sparse(torch.from_numpy(nb).to(self.device),
                                     torch.from_numpy(ed).to(self.device),
                                     edge_batch=p.edge_batch)
        return out, {"cache": self._note((p.cache_key(), (n_b, md_b, m_b)))}

    def _run_ring(self, g, p: Plan):
        from repro_torch.core.dynamic_pipeline import run_sequential
        from repro_torch.core.partition import stage_costs
        from repro_torch.core.triangle_pipeline import (
            build_dense_ring_operands,
            dense_ring_spec,
        )

        # pad_to a power-of-two per-stage row count: same-bucket graphs share
        # the block shapes, hence the cache key
        pad_to = bucket(max(-(-g.n_nodes // p.n_stages), 1), minimum=8)
        part, blocks = build_dense_ring_operands(
            g, p.n_stages, balance=p.balance, pad_to=pad_to, device=self.device)
        spec = dense_ring_spec(part.rows_per_stage)
        key = (p.cache_key(), ("ring", p.n_stages, part.rows_per_stage))
        out = run_sequential(spec, blocks, blocks, p.n_stages)
        return out, {"cache": self._note(key),
                     "stage_costs": stage_costs(g, part).tolist()}

    def _run_bitset_ring(self, g, p: Plan):
        from repro_torch.core.dynamic_pipeline import run_sequential
        from repro_torch.core.partition import stage_costs
        from repro_torch.core.triangle_pipeline import (
            bitset_ring_spec,
            build_bitset_ring_operands,
        )

        pad_to = bucket(max(-(-g.n_nodes // p.n_stages), 1), minimum=8)
        edge_block = bucket(max(-(-g.n_edges // p.n_stages), 1), minimum=128)
        part, masks, edges = build_bitset_ring_operands(
            g, p.n_stages, balance=p.balance, pad_to=pad_to, edge_block=edge_block,
            device=self.device)
        spec = bitset_ring_spec()
        key = (p.cache_key(), ("bitset", p.n_stages) + tuple(masks.shape)
               + tuple(edges.shape))
        out = run_sequential(spec, masks, edges, p.n_stages)
        return out, {"cache": self._note(key),
                     "stage_costs": stage_costs(g, part).tolist()}

    def _run_mapreduce(self, g, p: Plan):
        from repro_torch.core.triangle_mapreduce import (
            _mapreduce_count,
            build_mapreduce_operands,
        )

        # int64 keys on every device: the u*base+v encoding needs no clamp
        n_b = bucket(g.n_nodes)
        nbrs, keys, n = build_mapreduce_operands(g, key_base=n_b)
        _, dmax = nbrs.shape
        d_b = bucket(max(dmax, 1), minimum=8)
        # bucket space: sentinel and key base both become n_b
        nb = np.full((n_b, d_b), n_b, np.int64)
        nb[:n, :dmax] = np.where(nbrs == n, n_b, nbrs)
        m_b = bucket(max(g.n_edges, 1), minimum=256)
        ks = np.full(m_b, np.int64(n_b) * n_b, np.int64)  # > any real key
        ks[: g.n_edges] = keys
        out = _mapreduce_count(torch.from_numpy(nb).to(self.device),
                               torch.from_numpy(ks).to(self.device),
                               n=n_b, node_batch=p.node_batch)
        return out, {"cache": self._note((p.cache_key(), (n_b, d_b, m_b)))}


_METHOD_ALIASES = {"bitset": "bitset_ring"}
_PLAN_KWARGS = {"n_stages", "use_kernel", "interpret", "balance",
                "edge_batch", "node_batch", "block_size"}


def count_triangles(g, *, method: str = "auto", counter: TriangleCounter | None = None,
                    device=None, **kw) -> int:
    """Count triangles with one call: ``method="auto"`` routes through the
    planner, any other method (``dense``, ``sparse``, ``ring``, ``bitset``,
    ``mapreduce``) is forced. ``counter`` defaults to a new
    ``TriangleCounter(device=device)``; keyword arguments are plan fields."""
    c = counter or TriangleCounter(device=device)
    if method == "auto":
        return c.count(g).item()
    method = _METHOD_ALIASES.get(method, method)
    unknown = set(kw) - _PLAN_KWARGS
    if unknown:
        raise TypeError(f"unsupported kwargs {sorted(unknown)} for method {method!r}")
    fields = {**backend_exec_flags(c.resources), **kw}
    p = Plan(method=method, reason=f"fixed method={method!r} via count_triangles",
             **fields)
    return c.count(g, plan=p).item()
