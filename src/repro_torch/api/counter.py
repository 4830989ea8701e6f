"""``TriangleCounter`` — the planned execution engine.

One object owns one device, and optionally a ring mesh
(``launch.mesh.RingMesh``) for the ring plans and sharded streams of its
width. Operands are padded up to power-of-two
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
contradicts the device is refused with a ``ValueError``.

Streams run through :class:`StreamSession` (``open_stream``,
``count_stream``, ``count_windowed``, ``restore_stream``): the two-phase
bitset ingest of ``core.streaming`` — or, for a ``state_layout="hybrid"``
plan, its degree-aware hybrid state (hub bitset rows + tail buffers, linear
in n) — whose state lives on the counter's device (a ring-sharded plan's
shards on the mesh's stages when the mesh hosts its ring), and
:class:`SessionCheckpoint`, whose arrays keep the reference's layout.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Any, Iterable

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.api.planner import GraphStats, Plan, Resources, backend_exec_flags
from repro_torch.api.planner import plan as plan_fn
from repro_torch.utils import resolve_device


def bucket(x: int, minimum: int = 64) -> int:
    """Next power of two >= x (>= minimum) — the shape-bucketing policy."""
    b = minimum
    while b < x:
        b *= 2
    return b


@dataclasses.dataclass
class CountResult:
    """The single result contract for every counting path.

    count:  device tensor (int64) — scalar for ``count``/``count_stream``,
            a vector of per-graph counts for ``count_batch``. Stays on
            device until ``.item()`` so hot loops avoid per-call syncs.
    plan:   the executed :class:`Plan` (method, predicted bytes, reason).
    wall_s: host wall time of build+launch (launches are asynchronous: it
            excludes device completion unless the path synchronizes anyway).
            A stream's is the sum of its sessions' ingest spans.
    stats:  per-run details — cache key and hit, stage costs for
            ring plans, block counts for streams.
    """

    count: Any
    plan: Plan
    wall_s: float
    stats: dict = dataclasses.field(default_factory=dict)

    def item(self) -> int:
        """The count on the host: waits for the device, then copies (the
        ``count.wait`` span)."""
        with tracing.span("count.wait"):
            return int(self.count.item())

    def __int__(self) -> int:
        return self.item()


@dataclasses.dataclass
class SessionCheckpoint:
    """A host-side, bit-exact snapshot of one :class:`StreamSession` — the
    unit of preemption, spill and migration.

    Taken by :meth:`StreamSession.checkpoint` (which first flushes the
    buffered tail, so the snapshot covers exactly "every edge fed so far")
    and consumed by :meth:`TriangleCounter.restore_stream`, which resumes the
    stream BIT-IDENTICALLY: same state arrays, same cache key, same sticky
    re-blocking shapes (``buffer_shape``), same running stats.

    ``arrays`` has the reference's layout — ``{adj, count}`` unbounded,
    ``{epochs, counts, head}`` windowed, with the leading stage axis kept
    for sharded states, ``{hub_adj, hub_ids, hub_slot, tail_nbr, deg,
    count, lost}`` hybrid; bitsets uint32, ``head`` int32, counts int64 (the
    reference's int32 counts are widened on restore) — so checkpoints move
    between the two packages. ``nbytes`` is what the snapshot charges
    against a host budget; ``state_bytes`` the device footprint the session
    pins when restored. ``spill``/``load_arrays`` round-trip the arrays
    through one COMPRESSED ``.npz`` file (``arrays`` is None while spilled,
    ``disk_bytes`` the file's size).
    """

    n_nodes: int
    plan: Plan
    block_size: int
    state_bytes: int
    nbytes: int
    arrays: dict | None
    buffer_shape: dict
    n_blocks: int
    n_epochs_advanced: int
    wall_s: float
    path: str | None = None
    disk_bytes: int | None = None

    @property
    def spilled(self) -> bool:
        return self.arrays is None

    def spill(self, path: str) -> None:
        """Move the snapshot arrays from host memory to one COMPRESSED
        ``.npz`` at ``path``; everything else stays in the object.
        Idempotent on an already-spilled checkpoint."""
        if self.arrays is None:
            return
        meta = json.dumps({
            "n_nodes": self.n_nodes, "plan": self.plan.to_dict(),
            "block_size": self.block_size, "state_bytes": self.state_bytes,
            "nbytes": self.nbytes, "buffer_shape": self.buffer_shape,
            "n_blocks": self.n_blocks,
            "n_epochs_advanced": self.n_epochs_advanced,
            "wall_s": self.wall_s})
        with tracing.span("ckpt.spill"):
            np.savez_compressed(path, __meta__=np.array(meta), **self.arrays)
        self.arrays, self.path = None, path
        self.disk_bytes = int(os.path.getsize(path))

    def load_arrays(self) -> dict:
        """The snapshot arrays, loading (and deleting) the spill file if the
        checkpoint was spilled."""
        if self.arrays is None:
            with tracing.span("ckpt.load"), np.load(self.path) as z:
                self.arrays = {k: z[k] for k in z.files if k != "__meta__"}
            os.remove(self.path)
            self.path, self.disk_bytes = None, None
        return self.arrays

    def discard(self) -> None:
        """Drop the snapshot (and its spill file, if any)."""
        if self.path is not None and os.path.exists(self.path):
            os.remove(self.path)
        self.arrays, self.path = None, None

    def finalize_result(self) -> CountResult:
        """Finalize WITHOUT touching the device: the snapshot covers every
        edge fed, so the count is read out of the host arrays — the running
        total, or the sum of the epoch ring's per-slot counters — as an
        int64 tensor on the CPU (an int32 count from the reference is
        widened). Equal to restoring and finalizing."""
        arrays = self.load_arrays()
        p = self.plan
        if int(arrays.get("lost", 0)):
            raise RuntimeError(
                f"hybrid stream checkpoint recorded {int(arrays['lost'])} dropped "
                f"edge endpoint(s) — its count is not exact and cannot be finalized")
        key = "counts" if p.window_epochs else "count"
        count = torch.tensor(int(arrays[key].astype(np.int64).sum()), dtype=torch.int64)
        stats = {"n_blocks": self.n_blocks, "block_size": self.block_size,
                 "n_stages": p.n_stages, "sharded": p.n_stages > 1,
                 "session": True, "from_checkpoint": True,
                 "state_bytes": self.nbytes}
        if p.window_epochs:
            stats["window_epochs"] = p.window_epochs
            stats["epochs_advanced"] = self.n_epochs_advanced
        return CountResult(count=count, plan=p, wall_s=self.wall_s, stats=stats)

    @classmethod
    def from_file(cls, path: str) -> "SessionCheckpoint":
        """Rehydrate a checkpoint that something else spilled — the port or
        the reference (the migration entry point)."""
        with np.load(path) as z:
            meta = json.loads(str(z["__meta__"][()]))
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
        return cls(n_nodes=meta["n_nodes"], plan=Plan.from_dict(meta["plan"]),
                   block_size=meta["block_size"],
                   state_bytes=meta["state_bytes"], nbytes=meta["nbytes"],
                   arrays=arrays, buffer_shape=meta["buffer_shape"],
                   n_blocks=meta["n_blocks"],
                   n_epochs_advanced=meta["n_epochs_advanced"],
                   wall_s=meta["wall_s"],
                   disk_bytes=int(os.path.getsize(path)))


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

    ``device`` defaults to ``cuda`` (with a ``mesh``, its first stage's
    device) and raises without a card; pass ``device="cpu"`` for the plain
    PyTorch versions. ``resources`` defaults to :meth:`Resources.detect` on
    that device. ``mesh`` (a ``launch.mesh.RingMesh`` of the counter's
    device type, else ``ValueError``) routes ring plans of its width
    through ``DynamicPipeline`` and ring-sharded streams through the mesh
    ingests; without one, ring plans run the paper-faithful stage chain on
    the one device and sharded streams emulate their stages there.

    ``delta_pool`` (``core.streaming.DeltaPool``) keeps the bitset
    sessions' delta table clean between their blocks, so an ingest fills
    none. It holds one table a device, until ``delta_pool.trim`` drops it:
    a stream multiplexer trims it at each admission, ``count_stream`` and
    ``count_windowed`` at their end.
    """

    def __init__(self, resources: Resources | None = None, *,
                 plan: Plan | None = None, device=None, mesh=None):
        from repro_torch.core.streaming import DeltaPool

        if mesh is not None and device is None:
            device = mesh.devices[0]
        self.device = resolve_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a mesh of {mesh.device_type!r} stages on a counter of "
                             f"device {self.device}")
        self.resources = resources or Resources.detect(self.device)
        self.fixed_plan = plan
        self.mesh = mesh
        self._seen: dict[tuple, int] = {}  # cache key -> uses
        self.delta_pool = DeltaPool()

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
        with tracing.timed("counter.count") as sp:
            executor = getattr(self, f"_run_{p.method}", None)
            if executor is None:
                raise ValueError(f"plan method {p.method!r} not executable here")
            self._check_plan(p)
            count, stats = executor(g, p)
        return CountResult(count=count, plan=p, wall_s=sp.seconds, stats=stats)

    # -- streaming entry points -------------------------------------------
    def open_stream(self, n_nodes: int, *, plan: Plan | None = None,
                    block_size: int | None = None,
                    window: int | None = None) -> "StreamSession":
        """Open a :class:`StreamSession` — the handle behind every streaming
        entry point (``count_stream`` is open → feed → finalize in one call).

        Plan resolution: the ``plan`` argument, else the counter's fixed
        plan, else the planner on not-memory-resident stats — resolved
        BEFORE the block size, so the planner's ``block_size``/``n_stages``
        apply; an explicit ``block_size`` argument still overrides the
        plan's. Plans whose method is not ``"stream"`` are rejected, and so
        is a plan that contradicts the device (``ValueError``).

        ``window = E`` opens a SLIDING-WINDOW session (a ring of E epoch
        bitsets, E·n²/8 bytes): ``feed`` lands edges in the current epoch,
        :meth:`StreamSession.advance` slides the window, and ``finalize``
        returns the live window's count. A resolved plan's
        ``window_epochs`` must agree with ``window``.

        The session's uses are recorded under ``(plan.cache_key(),
        ("stream", n_nodes, block_size, on_mesh))``, ``on_mesh`` being
        :meth:`mesh_matches` of the plan's ring width."""
        p = plan or self.fixed_plan
        if p is None:
            stats = GraphStats(n_nodes=n_nodes, n_edges=0, replication_factor=0,
                               max_degree=0, max_fwd_degree=0, edges_in_memory=False)
            p = plan_fn(stats, self.resources, window_epochs=window or 0)
        elif window is not None and p.window_epochs != window:
            raise ValueError(
                f"window={window} conflicts with the resolved plan's "
                f"window_epochs={p.window_epochs} — pass the window through "
                f"the plan OR the argument, not both")
        if p.method != "stream":
            raise ValueError(
                f"count_stream requires a plan with method='stream', got "
                f"{p.method!r} — use count()/count_batch() for memory-resident "
                f"plans, or drop the plan to let the planner size the stream")
        if p.state_layout == "hybrid" and (p.window_epochs or p.n_stages > 1):
            raise ValueError(
                "state_layout='hybrid' supports only unbounded single-stage "
                f"streams (got window_epochs={p.window_epochs}, "
                f"n_stages={p.n_stages}) — the windowed epoch ring and the "
                "mesh stage axis stay bitset")
        if block_size is None:
            block_size = p.block_size
        return StreamSession(self, n_nodes, p, block_size, self.mesh_matches(p.n_stages))

    def restore_stream(self, ckpt: SessionCheckpoint) -> "StreamSession":
        """Resume a checkpointed stream session — the other half of
        :meth:`StreamSession.checkpoint`. The restored session continues
        BIT-IDENTICALLY to one that was never interrupted: the state arrays
        are rehydrated exactly on this counter's device
        (``core.streaming.restore_state``; an int32 count from the
        reference is widened to int64), the session records the SAME cache
        key, and the re-blocking buffer resumes the checkpoint's sticky
        shapes. A checkpoint whose plan contradicts this counter's device is
        refused with a ``ValueError``. A ring-sharded checkpoint restores
        onto a mesh and an emulated counter alike (the snapshot has the
        emulated (S, ...) layout either way)."""
        from repro_torch.core import streaming

        self.check_stream_plan(ckpt.plan)
        on_mesh = self.mesh_matches(ckpt.plan.n_stages)
        session = StreamSession(
            self, ckpt.n_nodes, ckpt.plan, ckpt.block_size, on_mesh,
            state=streaming.restore_state(ckpt.load_arrays(), device=self.device,
                                          mesh=self.mesh if on_mesh else None))
        session._buffer.import_shape_state(ckpt.buffer_shape)
        session.n_blocks = ckpt.n_blocks
        session.n_epochs_advanced = ckpt.n_epochs_advanced
        session._wall = ckpt.wall_s
        session.restored = True
        return session

    def count_stream(self, n_nodes: int, blocks: Iterable, *,
                     plan: Plan | None = None,
                     block_size: int | None = None) -> CountResult:
        """Fold an iterable of (B, 2) edge blocks — ``core.streaming`` behind
        the same result contract, as a one-session wrapper over
        :meth:`open_stream` (see it for plan resolution and cache keying).
        ``n_stages > 1`` runs the column-sharded ingest: on ``self.mesh``
        when its width matches, else its stages emulated on this device.
        The stream leaves no delta table in :attr:`delta_pool`."""
        session = self.open_stream(n_nodes, plan=plan, block_size=block_size)
        try:
            for b in blocks:
                session.feed(b)
            return session.finalize()
        finally:
            self.delta_pool.trim(0)

    def count_windowed(self, n_nodes: int, epochs: Iterable, *,
                       window: int | None = None, plan: Plan | None = None,
                       block_size: int | None = None) -> CountResult:
        """Count triangles over a SLIDING WINDOW of an edge stream: consume
        an iterable of EPOCHS — each an iterable of (B, 2) edge blocks — and
        return the count of the final window (the last ``window`` epochs).
        A one-session wrapper over :meth:`open_stream` with ``window=``: the
        window advances between epochs (one epoch-slot clear, no per-edge
        deletes). The stream leaves no delta table in :attr:`delta_pool`."""
        p = plan or self.fixed_plan
        if not window and (p is None or not p.window_epochs):
            # validate BEFORE open_stream allocates state for a session that
            # would never run
            raise ValueError(
                "count_windowed needs a windowed session — pass window=E or "
                "a plan with window_epochs > 0")
        session = self.open_stream(n_nodes, plan=plan, block_size=block_size,
                                   window=window)
        try:
            first = True
            for epoch_blocks in epochs:
                if not first:
                    session.advance()
                first = False
                for b in epoch_blocks:
                    session.feed(b)
            return session.finalize()
        finally:
            self.delta_pool.trim(0)

    def check_stream_plan(self, p: Plan) -> None:
        """Raise ``ValueError`` when ``p``'s kernel flags contradict this
        counter's device (a stream multiplexer checks a caller's plan at
        ``open``, before the session waits for memory)."""
        self._check_plan(p)

    def delta_pool_words(self, n_nodes: int, plan: Plan) -> int:
        """Words of the delta table a stream session under ``plan`` takes
        from :attr:`delta_pool` each block: n·ceil(W/S) for a bitset session
        on this device, 0 for a hybrid one or one on the mesh."""
        from repro_torch.core.streaming import delta_words

        if plan.state_layout == "hybrid" or self.mesh_matches(plan.n_stages):
            return 0
        return delta_words(n_nodes, plan.n_stages)

    def mesh_matches(self, n_stages: int) -> bool:
        """True when this counter's mesh hosts a ``n_stages``-wide ring
        (the mesh has more than one stage and exactly ``n_stages``); any
        other width runs the stage chain or the emulated sharding instead of
        failing. Admission branches on this: an emulated shard pays the
        FULL bitset, and so do mesh shards that share one device
        (``planner.device_state_bytes``)."""
        return self.mesh is not None and self.mesh.size > 1 and self.mesh.size == n_stages

    def _ring(self, spec, p: Plan):
        """The callable that runs ``spec`` for plan ``p``: the mesh's
        pipeline (memoized per spec) when the mesh hosts the plan's ring,
        else the stage chain on this device."""
        from repro_torch.core.dynamic_pipeline import mesh_runtime, run_sequential

        if not self.mesh_matches(p.n_stages):
            return lambda r, s: run_sequential(spec, r, s, p.n_stages)
        return mesh_runtime(self.mesh, self.mesh.axis_names[0]).pipeline.jit(spec)

    def _run_stream(self, g, p: Plan):
        # A memory-resident graph executed under a stream plan: feed its own
        # edge list as blocks. Shrink the block to the graph so a 100-edge
        # input is not padded to 65536 phantom rows.
        p_run = dataclasses.replace(
            p, block_size=min(p.block_size, bucket(max(g.n_edges, 1), minimum=256)))
        res = self.count_stream(g.n_nodes, [g.edges], plan=p_run)
        return res.count, res.stats

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
        bucket))``. Graphs pad to the node bucket, which keys the cache, but
        the kernel runs over the largest graph's own rows, a view of the
        bucket; the batch itself is not padded, since an eager launch needs
        no fixed batch shape."""
        if not graphs:
            raise ValueError("empty batch")
        p = plan or self.batch_plan()
        if p.method != "dense":
            raise ValueError(
                f"count_batch is the batched dense path; got a plan with "
                f"method={p.method!r}")
        self._check_plan(p)
        from repro_torch.core.triangle_pipeline import count_triangles_dense

        with tracing.timed("counter.count_batch") as sp:
            n_max = max(g.n_nodes for g in graphs)
            n_b = bucket(n_max)
            b_b = bucket(len(graphs), minimum=8)
            us = _forward_adjacency_batch(graphs, n_b, self.device)
            key = (("batch_dense",) + p.cache_key(), (b_b, n_b))
            counts = count_triangles_dense(us[:, :n_max, :n_max])
        return CountResult(
            count=counts, plan=p, wall_s=sp.seconds,
            stats={"cache": self._note(key),
                   "batch_size": len(graphs), "bucket": (b_b, n_b)},
        )

    # -- executors (one per plan method) -----------------------------------
    def _run_dense(self, g, p: Plan):
        from repro_torch.core.triangle_pipeline import count_triangles_dense

        n, n_b = g.n_nodes, bucket(g.n_nodes)
        u = _forward_adjacency_batch([g], n_b, self.device)[0]
        # the bucket keys the cache; the kernel runs over the graph's own rows
        count = count_triangles_dense(u[:n, :n])
        return count, {"cache": self._note((p.cache_key(), (n_b,)))}

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
        out = self._ring(spec, p)(blocks, blocks)
        return out, {"cache": self._note(key),
                     "stage_costs": stage_costs(g, part).tolist()}

    def _run_bitset_ring(self, g, p: Plan):
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
        out = self._ring(spec, p)(masks, edges)
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



class StreamSession:
    """One in-flight streaming count: open → ``feed`` blocks → ``finalize``.

    The handle owns this stream's state on the counter's device — the
    adjacency-so-far bitset (n²/8 bytes; for a ring-sharded plan its S
    column shards, each on its stage's device when the counter's mesh hosts
    the ring (``on_mesh``), else all emulated on this device; for a windowed
    plan a ring of E epoch bitsets, E·n²/8; for a hybrid plan hub rows and
    tail buffers, ``core.streaming.hybrid_state_nbytes``) — plus a
    :class:`~repro_torch.core.streaming.BlockBuffer` that re-blocks ragged
    feeds to one fixed shape. Sessions are independent and interleavable
    from one driver thread; the handle itself is not thread-safe.

    ``feed`` ingests every full block the new edges completed and buffers
    the remainder on the host (at most ``block_size - 1`` edges). Windowed
    sessions add :meth:`advance`: flush the current epoch's tail and slide
    the window one epoch. ``finalize`` flushes the padded tail and returns
    the :class:`CountResult` (the running total, or the LIVE WINDOW's
    count); it is idempotent, and later ``feed``/``advance`` calls raise.
    Nothing here synchronises with the device before ``finalize`` or
    ``checkpoint``. ``state_bytes`` is the device footprint the session
    pins while open, on its busiest device.
    """

    def __init__(self, counter: TriangleCounter, n_nodes: int, plan: Plan,
                 block_size: int, on_mesh: bool = False, *, state: dict | None = None):
        from repro_torch.api.planner import device_state_bytes
        from repro_torch.core import streaming

        counter.check_stream_plan(plan)
        self.counter = counter
        self.n_nodes = n_nodes
        self.plan = plan
        self.block_size = block_size
        dev = counter.device
        mesh = counter.mesh if on_mesh else None
        self._buffer = streaming.BlockBuffer(n_nodes, block_size, device=dev)
        self._key = (plan.cache_key(), ("stream", n_nodes, block_size, on_mesh))
        self._cache = counter._note(self._key)
        self._on_mesh = on_mesh
        self.restored = False
        # The card's reserve charges one ingest's scratch, the largest, so an
        # ingest that allocates more than its delta table first trims the
        # pool to the table it takes (_pool_cap): its own for a window,
        # beside its age-cumulative tables, none for a hybrid or mesh
        # ingest. A bitset ingest allocates only its table (None: no trim).
        pool = counter.delta_pool
        self._pool_cap = counter.delta_pool_words(n_nodes, plan)
        if plan.state_layout == "hybrid":
            self._ingest = functools.partial(streaming.ingest_block_hybrid,
                                             hub_threshold=plan.hub_threshold)
        elif on_mesh:
            self._ingest = (streaming.make_mesh_ingest_windowed(mesh) if plan.window_epochs
                            else streaming.make_mesh_ingest(mesh))
        elif plan.window_epochs:
            self._ingest = functools.partial(
                streaming.ingest_block_windowed_sharded if plan.n_stages > 1
                else streaming.ingest_block_windowed, pool=pool)
        else:
            self._ingest = functools.partial(
                streaming.ingest_block_sharded if plan.n_stages > 1
                else streaming.ingest_block, pool=pool)
            self._pool_cap = None
        if state is not None:
            # restore path (TriangleCounter.restore_stream): adopt the
            # checkpointed arrays instead of allocating zeros
            self.state = state
        elif plan.state_layout == "hybrid":
            self.state = streaming.init_hybrid_state(
                n_nodes, plan.hub_slots, plan.tail_capacity, device=dev)
        elif plan.window_epochs:
            self.state = (streaming.init_windowed_sharded_state(
                n_nodes, plan.window_epochs, plan.n_stages, device=dev, mesh=mesh)
                if plan.n_stages > 1 else
                streaming.init_windowed_state(n_nodes, plan.window_epochs, device=dev))
        elif plan.n_stages > 1:
            self.state = streaming.init_sharded_state(n_nodes, plan.n_stages, device=dev,
                                                      mesh=mesh)
        else:
            self.state = streaming.init_state(n_nodes, device=dev)
        # per-device footprint: one column shard per stage a device hosts on
        # the mesh; the WHOLE array when the sharding is emulated on one
        # device — admission must charge all of it
        nbytes = self._state_nbytes()
        self.state_bytes = (nbytes if plan.state_layout == "hybrid" else
                            device_state_bytes(nbytes // plan.n_stages, plan.n_stages, mesh))
        self.n_blocks = 0
        self.n_epochs_advanced = 0
        self._traces0 = streaming.ingest_trace_count()
        self._wall = 0.0
        self.result: CountResult | None = None

    def _state_nbytes(self) -> int:
        """Device bytes this session's state pins: the bitset array, or for
        a hybrid plan the sum over all its arrays — exactly the planner's
        ``predicted_bytes``."""
        from repro_torch.core.streaming import state_nbytes

        if self.plan.state_layout == "hybrid":
            return state_nbytes(self.state)
        key = "epochs" if self.plan.window_epochs else "adj"
        return state_nbytes({key: self.state[key]})

    @property
    def closed(self) -> bool:
        return self.result is not None

    def _live(self) -> None:
        if self.result is not None:
            raise RuntimeError("session already finalized")

    def _ingest_block(self, block) -> float:
        """Enqueue one padded block's launches (the ``ingest.block`` span);
        returns the host seconds that took."""
        with tracing.timed("ingest.block") as sp:
            tracing.count("ingest.blocks", key=len(block))
            if self._pool_cap is not None:
                self.counter.delta_pool.trim(self._pool_cap)
            self._ingest(self.state, block)
        self.n_blocks += 1
        return sp.seconds

    def _ingest_tail(self) -> float:
        """Flush the buffered tail and ingest it (the ``ingest.tail``
        span); returns the host seconds that took."""
        with tracing.timed("ingest.tail") as sp:
            with tracing.span("ingest.reblock"):
                tail = self._buffer.flush()
            if tail is not None:
                self._ingest_block(tail)
        return sp.seconds

    def feed(self, edges) -> None:
        """Buffer ``edges`` ((B, 2) array-like, any B including ragged);
        ingest every full ``block_size`` block they completed (into the
        CURRENT epoch for windowed sessions). Front-door validation
        (``core.streaming.validate_edges``): non-integer arrays, shapes
        other than (B, 2), and vertex ids outside ``[0, n_nodes)`` raise
        ``ValueError``."""
        self._live()
        from repro_torch.core import streaming

        edges = streaming.validate_edges(edges, self.n_nodes)
        with tracing.timed("ingest.reblock") as sp:
            blocks = self._buffer.push(edges)
        self._wall += sp.seconds
        for b in blocks:
            self._wall += self._ingest_block(b)

    # -- split surface for an async driver: feed() = reblock() + ingest_ready()
    # per emitted block, so a producer thread can own the host half
    # (validation, re-blocking, the host-to-device copy) while the drive
    # thread owns the device half; BlockBuffer's SPSC guard enforces one
    # thread at a time in the host half.
    def reblock(self, edges) -> list:
        """PRODUCER half of an async ``feed``: validate ``edges`` and push
        them through the re-blocking buffer, returning every device-ready
        fixed-shape block they completed. Touches no state and no stats;
        the caller routes every returned block through :meth:`ingest_ready`
        IN ORDER."""
        self._live()
        from repro_torch.core import streaming

        edges = streaming.validate_edges(edges, self.n_nodes)
        with tracing.span("ingest.reblock"):
            return self._buffer.push(edges)

    def flush_ready(self):
        """PRODUCER half of an async tail flush: the padded tail block (None
        when nothing is buffered), NOT ingested."""
        self._live()
        with tracing.span("ingest.reblock"):
            return self._buffer.flush()

    def ingest_ready(self, block) -> float:
        """CONSUMER half of an async ``feed``: ingest one already-padded
        block (from :meth:`reblock` / :meth:`flush_ready`). Called in the
        order the blocks were produced, the device work is IDENTICAL to a
        synchronous ``feed`` of the same edges. Returns the host seconds the
        ingest took (its ``ingest.block`` span)."""
        self._live()
        seconds = self._ingest_block(block)
        self._wall += seconds
        return seconds

    def expire_ready(self) -> None:
        """CONSUMER half of an async ``advance``: slide the window WITHOUT
        flushing the tail (the producer already flushed it through
        :meth:`flush_ready`)."""
        self._live()
        if not self.plan.window_epochs:
            raise RuntimeError(
                "expire_ready() is for windowed sessions — open with "
                "window=E (or a plan with window_epochs > 0)")
        from repro_torch.core import streaming

        with tracing.timed("ingest.expire") as sp:
            streaming.expire_epoch(self.state)
        self.n_epochs_advanced += 1
        self._wall += sp.seconds

    def set_block_size(self, block_size: int) -> list:
        """Adaptive re-blocking: change the emitted block shape from the
        next block on (counts are invariant to re-blocking). Returns any
        blocks the buffered remainder completed at the new size — route
        them through :meth:`ingest_ready` in order. A later checkpoint
        carries the CURRENT shape."""
        self._live()
        with tracing.span("ingest.reblock"):
            out = self._buffer.set_block_size(block_size)
        self.block_size = int(block_size)
        return out

    def checkpoint(self) -> SessionCheckpoint:
        """Snapshot this session to host memory — the preemption primitive.

        The buffered tail is flushed and ingested first, so the snapshot
        covers EXACTLY the edges fed so far; then every state array is
        copied to the host bit-exactly. The session stays usable (a
        snapshot, not a close). Raises after ``finalize``, and for a hybrid
        session that dropped edge endpoints (its count is not exact)."""
        self._live()
        from repro_torch.core import streaming

        tail_s = self._ingest_tail()
        with tracing.timed("ckpt.snapshot") as sp:
            arrays = streaming.snapshot_state(self.state)
        if int(arrays.get("lost", 0)):
            raise RuntimeError(
                f"refusing to checkpoint a hybrid session that dropped "
                f"{int(arrays['lost'])} edge endpoint(s) — the snapshot would "
                f"persist an inexact count")
        self._wall += tail_s + sp.seconds
        return SessionCheckpoint(
            n_nodes=self.n_nodes, plan=self.plan, block_size=self.block_size,
            state_bytes=self.state_bytes,
            nbytes=streaming.state_nbytes(arrays), arrays=arrays,
            buffer_shape=self._buffer.export_shape_state(),
            n_blocks=self.n_blocks, n_epochs_advanced=self.n_epochs_advanced,
            wall_s=self._wall)

    def advance(self) -> None:
        """Slide a WINDOWED session's window by one epoch: the closing
        epoch's buffered tail is flushed and ingested first (epoch
        boundaries bind edges to the epoch they were fed in), then the
        oldest epoch's bitset and count slot are cleared in one shot
        (``core.streaming.expire_epoch``). Raises on unbounded sessions and
        after ``finalize``."""
        self._live()
        if not self.plan.window_epochs:
            raise RuntimeError(
                "advance() is for windowed sessions — open with window=E "
                "(or a plan with window_epochs > 0)")
        from repro_torch.core import streaming

        self._wall += self._ingest_tail()
        with tracing.timed("ingest.expire") as sp:
            streaming.expire_epoch(self.state)
        self.n_epochs_advanced += 1
        self._wall += sp.seconds

    def finalize(self) -> CountResult:
        """Flush the padded tail block and return the stream's
        :class:`CountResult` (idempotent): the running total, or the live
        window's count. The count stays a device tensor. ``wall_s`` is the
        host time spent re-blocking and enqueueing ingests inside
        ``feed``/``advance``/``checkpoint``/``finalize`` (the ingest is
        asynchronous on the card). ``stats["ingest_traces"]`` counts the new
        ingest keys over the session's lifetime. A hybrid session that
        dropped edge endpoints raises instead of returning a count (its
        ``lost`` counter is read here, once, with the hub slots in use: the
        ``hybrid.hubs_used`` counter while the tracer is on)."""
        if self.result is not None:
            return self.result
        from repro_torch.core import streaming

        self._wall += self._ingest_tail()
        p = self.plan
        if p.state_layout == "hybrid":
            lost = streaming.hybrid_lost(self.state)
            if lost:
                raise RuntimeError(
                    f"hybrid stream dropped {lost} edge endpoint(s): {p.hub_slots} hub "
                    f"slots exhausted while tail buffers of {p.tail_capacity} "
                    f"overflowed — re-plan with larger hub_slots/tail_capacity")
        count = (streaming.window_count(self.state) if p.window_epochs
                 else self.state["count"])
        stats = {"n_blocks": self.n_blocks, "block_size": self.block_size,
                 "n_stages": p.n_stages, "sharded": p.n_stages > 1,
                 "on_mesh": self._on_mesh, "session": True,
                 "state_bytes": self._state_nbytes(), "cache": self._cache,
                 "ingest_traces": streaming.ingest_trace_count() - self._traces0}
        if p.window_epochs:
            stats["window_epochs"] = p.window_epochs
            stats["epochs_advanced"] = self.n_epochs_advanced
        self.result = CountResult(count=count, plan=p, wall_s=self._wall, stats=stats)
        return self.result


_DEFAULT: dict = {}


def default_counter(device=None) -> TriangleCounter:
    """The module-level counter of ``device`` (``cuda`` unless asked for
    another), shared by the ``count_triangles`` shim so casual callers keep
    one counter — one set of cache keys — across calls."""
    dev = resolve_device(device)
    if dev not in _DEFAULT:
        _DEFAULT[dev] = TriangleCounter(device=dev)
    return _DEFAULT[dev]


_METHOD_ALIASES = {"bitset": "bitset_ring"}
_PLAN_KWARGS = {"n_stages", "use_kernel", "interpret", "balance",
                "edge_batch", "node_batch", "block_size"}


def count_triangles(g, *, method: str = "auto", counter: TriangleCounter | None = None,
                    device=None, **kw) -> int:
    """Count triangles with one call: ``method="auto"`` routes through the
    planner, any other method (``dense``, ``sparse``, ``ring``, ``bitset``,
    ``mapreduce``) is forced. ``counter`` defaults to
    :func:`default_counter` of ``device``; keyword arguments are plan
    fields. Other keywords — the reference's legacy ring kwargs ``mesh=``
    and ``sequential=`` — fall through, as in the reference, to the ring
    entry points ``count_triangles_ring`` / ``count_triangles_bitset_ring``
    (on ``counter``'s device, else ``device``, else the mesh's); for any
    other method they raise ``TypeError``."""
    method = _METHOD_ALIASES.get(method, method)
    unknown = set(kw) - _PLAN_KWARGS
    if unknown and method != "auto":
        from repro_torch.core import triangle_pipeline as tp

        legacy = {"ring": tp.count_triangles_ring,
                  "bitset_ring": tp.count_triangles_bitset_ring}
        if method in legacy:
            return int(legacy[method](
                g, device=counter.device if counter is not None else device, **kw))
        raise TypeError(f"unsupported kwargs {sorted(unknown)} for method {method!r}")
    c = counter or default_counter(device)
    if method == "auto":
        return c.count(g).item()
    fields = {**backend_exec_flags(c.resources), **kw}
    p = Plan(method=method, reason=f"fixed method={method!r} via count_triangles",
             **fields)
    return c.count(g, plan=p).item()
