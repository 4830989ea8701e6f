"""Batched serving loops: the LM server (prefill + greedy decode over the
KV cache) and the triangle-counting server (the planner-driven
``repro_torch.api`` front end with one shared counter — one device, one
cache — across requests).

The LM server groups requests (prompt token arrays) into fixed-size
batches, pads short prompts on the left with a pad id, prefills once, then
decodes greedily until ``max_new_tokens``, as the reference's
(``repro/serve/serve_loop.py``) does. Left-pads are attended causally (no
pad mask in the step functions), so a mixed-length batch is approximate,
exactly as in the reference: a deployment would bucket requests by length
or add a pad mask.

The triangle server also serves streams: ``open_stream``/``feed``/
``close_stream`` (and ``serve_streams``, many at once) ride
``serve.sessions.StreamMultiplexer`` — planner admission, preemption,
deadlines, bounded backpressure and, with ``prefetch_depth=K``, background
re-blocking. ``ClusterServer`` is the same streaming surface over worker
PROCESSES (``serve.cluster``): sessions placed by planner-predicted bytes,
journaled, checkpointed, migrated and failed over by the router."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.models.transformer import Transformer, decode_step, prefill


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    max_new_tokens: int = 32
    pad_id: int = 0


class LMServer:
    """Greedy generation over a :class:`~repro_torch.models.transformer.
    Transformer` on the model's device. Prefill runs the chunked attention
    with ``chunk_q = min(512, prompt length)``, as the reference server's.
    Generated tokens stay on the device until a batch ends: one copy to
    the host per batch."""

    def __init__(self, model: Transformer, cfg: LMConfig, serve_cfg: ServeConfig | None = None):
        self.model = model
        self.cfg = cfg
        self.scfg = serve_cfg or ServeConfig()

    def generate(self, prompts: list[np.ndarray]) -> list[np.ndarray]:
        """Greedy-decode a list of int32 prompt arrays. Returns generated ids."""
        out: list[np.ndarray] = []
        for i in range(0, len(prompts), self.scfg.max_batch):
            out.extend(self._generate_batch(prompts[i:i + self.scfg.max_batch]))
        return out

    def _generate_batch(self, prompts: list[np.ndarray]) -> list[np.ndarray]:
        b = len(prompts)
        plen = max(len(p) for p in prompts)
        s_max = plen + self.scfg.max_new_tokens
        tokens = np.full((b, plen), self.scfg.pad_id, np.int32)
        for i, p in enumerate(prompts):
            tokens[i, plen - len(p):] = p  # left-pad → aligned last positions
        dev = self.model.device
        logits, cache = prefill(self.model, self.cfg, torch.from_numpy(tokens).to(dev), s_max,
                                chunk_q=min(512, plen))
        tok = logits.argmax(-1, keepdim=True)
        gen = [tok]
        for step in range(self.scfg.max_new_tokens - 1):
            logits, cache = decode_step(self.model, self.cfg, cache, tok, plen + step)
            tok = logits.argmax(-1, keepdim=True)
            gen.append(tok)
        stacked = torch.cat(gen, dim=1).to(torch.int32).cpu().numpy()
        return [stacked[i] for i in range(b)]


@dataclasses.dataclass
class TriangleServeConfig:
    max_batch: int = 16          # graphs per batched kernel launch
    batch_node_limit: int = 512  # dense-plan graphs up to this ride the batch path


class TriangleServer:
    """Serve triangle-count requests over ``repro_torch.api``.

    One ``TriangleCounter`` lives for the server's lifetime, on ``device``
    (``cuda`` unless ``device="cpu"`` is asked for; it raises without a
    card) and, with ``mesh=``, on that ring mesh: ring plans and
    ring-sharded streams of the mesh's width run on its stages. Small graphs whose plan is the dense path are grouped by padded
    node bucket and counted with ONE batched live-grid kernel launch per
    group (``count_batch``, executed under the group's planner plan so the
    backend decision survives batching); everything else runs its
    planner-chosen path individually.

    STREAMING requests (the paper's not-memory-resident regime) run as
    sessions on the server's :class:`~repro_torch.serve.sessions.
    StreamMultiplexer` (``self.streams``), over the same counter:
    ``open_stream`` → ``feed`` → ``close_stream``, ``serve_streams`` many
    at once round-robin, ``serve_stream`` one. Admission is the planner's
    budget (``admit_session``; on the card less the ingest scratch the
    multiplexer reserves): sessions that would overcommit
    ``Resources.memory_bytes`` queue host-side, and the scheduler is
    preemptible (``priority=``, ``deadline_s=``, ``preempt_stream``, bounded
    queue/checkpoint budgets that raise ``BackpressureError``).
    ``prefetch_depth=K`` gives every session an async prefetch pipeline and
    ``adaptive_block`` lets it resize blocks from the ingest's host wall.
    Results come back as per-request ``CountResult``s in request order —
    counts stay device tensors, so an aggregating caller syncs once, not per
    request.
    """

    def __init__(self, resources=None, serve_cfg: TriangleServeConfig | None = None,
                 mesh=None, prefetch_depth: int | None = None,
                 adaptive_block: bool = False, *, device=None):
        from repro_torch.api import TriangleCounter
        from repro_torch.serve.sessions import StreamMultiplexer

        self.counter = TriangleCounter(resources, device=device, mesh=mesh)
        self.cfg = serve_cfg or TriangleServeConfig()
        self.streams = StreamMultiplexer(self.counter,
                                         prefetch_depth=prefetch_depth,
                                         adaptive_block=adaptive_block)

    def serve(self, graphs: list) -> list:
        from repro_torch.api import CountResult, bucket

        cfg = self.cfg
        results: list = [None] * len(graphs)
        # node bucket -> (the group's planner plan, request indices). The
        # plan rides along so count_batch executes the planner's backend
        # decision instead of Plan defaults.
        batchable: dict[int, tuple] = {}
        for i, g in enumerate(graphs):
            p = self.counter.plan_for(g)
            if p.method == "dense" and g.n_nodes <= cfg.batch_node_limit:
                batchable.setdefault(bucket(g.n_nodes), (p, []))[1].append(i)
            else:
                results[i] = self.counter.count(g, plan=p)
        for group_plan, idx in batchable.values():
            for j in range(0, len(idx), cfg.max_batch):
                chunk = idx[j:j + cfg.max_batch]
                rb = self.counter.count_batch([graphs[i] for i in chunk],
                                              plan=group_plan)
                for pos, i in enumerate(chunk):
                    # amortized share of the batch call, so summing wall_s
                    # over a response doesn't multiply-count the batch (the
                    # full batch time stays in stats)
                    results[i] = CountResult(
                        count=rb.count[pos], plan=rb.plan,
                        wall_s=rb.wall_s / len(chunk),
                        stats={**rb.stats, "batched": True, "batch_pos": pos,
                               "batch_wall_s": rb.wall_s},
                    )
        return results

    # -- streaming sessions ------------------------------------------------
    def open_stream(self, n_nodes: int, *, plan=None, block_size: int | None = None,
                    window: int | None = None, priority: int = 0,
                    deadline_s: float | None = None) -> int:
        """Open one streaming session on the server's multiplexer; returns
        its session id (admitted, queued, or admitted by preempting
        strictly-lower-priority actives). ``window=E`` opens a
        sliding-window session; ``priority`` ranks it for fair-share
        scheduling; ``deadline_s`` reaps it if idle that long; ``plan``
        runs it under the caller's stream plan instead of the planner's."""
        return self.streams.open(n_nodes, plan=plan, block_size=block_size, window=window,
                                 priority=priority, deadline_s=deadline_s)

    def feed(self, sid: int, edges) -> None:
        """Feed one (B, 2) edge block to an open session (the current epoch
        for windowed sessions)."""
        self.streams.feed(sid, edges)

    def advance_stream(self, sid: int) -> None:
        """Slide a windowed session's window one epoch (buffered as an epoch
        marker while the session waits)."""
        self.streams.advance(sid)

    def preempt_stream(self, sid: int) -> None:
        """Park an ACTIVE session's device state host-side; it readmits when
        budget frees, and ``close_stream`` on it restores first so the count
        is exact."""
        self.streams.preempt(sid)

    def stream_status(self, sid: int) -> str:
        """``"active"`` / ``"queued"`` / ``"preempted"`` / ``"closed"``."""
        return self.streams.status(sid)

    def close_stream(self, sid: int):
        """Finalize a session; returns its ``CountResult`` (idempotent;
        cancels a never-admitted session, restores a preempted one)."""
        return self.streams.close(sid)

    def serve_streams(self, requests, *, block_size: int | None = None) -> list:
        """Serve many streaming requests CONCURRENTLY: ``requests`` is a list
        of ``(n_nodes, blocks-iterable)`` pairs; block ingest is interleaved
        round-robin across every session in request order (queued sessions
        buffer host-side). Sessions are closed in request order once the
        interleave finishes, so freed state admits queued requests FIFO.
        Returns per-request ``CountResult``s in request order, bit-identical
        to running each request through ``serve_stream`` alone. A request
        given as ``(n_nodes, blocks, plan)`` runs under that stream plan
        instead of the planner's (``StreamMultiplexer.open``)."""
        its = [iter(r[1]) for r in requests]
        sids = [self.streams.open(r[0], plan=r[2] if len(r) > 2 else None,
                                  block_size=block_size)
                for r in requests]
        live = set(range(len(requests)))
        while live:
            for i in sorted(live):
                try:
                    block = next(its[i])
                except StopIteration:
                    live.discard(i)
                    continue
                self.streams.feed(sids[i], block)
        return [self.streams.close(sid) for sid in sids]

    def serve_stream(self, n_nodes: int, blocks, *,
                     block_size: int | None = None):
        """Serve ONE streaming request (an iterable of (B, 2) edge blocks):
        a one-session wrapper over the multiplexer; the planner sizes the
        block from the server's resources."""
        return self.serve_streams([(n_nodes, blocks)],
                                  block_size=block_size)[0]


class ClusterServer:
    """The multi-host front door: ``TriangleServer``'s streaming surface
    over a :class:`~repro_torch.serve.cluster.ClusterRouter` of worker PROCESSES.

    Where ``TriangleServer`` multiplexes sessions inside one process (one
    host's ``Resources.memory_bytes`` caps the aggregate state), the
    cluster server places each session on a worker by planner-predicted
    state bytes (``place_session``: least-loaded-by-bytes, never-fits
    rejection at ``open_stream``) and rides the router's durability
    machinery — journaled feeds, checkpoint barriers, live migration, and
    failover that resurrects a dead worker's sessions from their spilled
    checkpoints. Session ids are GLOBAL (router-issued); results are the
    same ``CountResult``s, counts bit-identical to a single-process run.

    ``workers`` is a list of :class:`~repro_torch.serve.cluster.WorkerClient`\\ s
    or spawn-spec dicts (``{"memory_bytes": ..., "devices": ...,
    "device": ...}``; a worker runs on ``cuda`` unless its spec says
    ``"device": "cpu"``); remaining keyword arguments go to the router. Use as a context manager
    (or call ``shutdown()``) so worker subprocesses are reaped."""

    def __init__(self, workers, **router_kwargs):
        from repro_torch.serve.cluster import ClusterRouter

        self.router = ClusterRouter(workers, **router_kwargs)

    # -- TriangleServer's streaming surface, routed ------------------------
    def open_stream(self, n_nodes: int, *, block_size: int | None = None,
                    window: int | None = None, priority: int = 0) -> int:
        """Place one streaming session on the least-loaded fitting worker;
        returns its global session id. ``BackpressureError`` = fits no
        worker at current load (retry after closes); ``ValueError`` = could
        never fit any worker, even idle."""
        return self.router.open(n_nodes, block_size=block_size,
                                window=window, priority=priority)

    def feed(self, sid: int, edges) -> None:
        """Feed one (B, 2) edge block (journaled, then dispatched)."""
        self.router.feed(sid, edges)

    def advance_stream(self, sid: int) -> None:
        """Slide a windowed session's window one epoch."""
        self.router.advance(sid)

    def stream_status(self, sid: int) -> str:
        """``"active"`` / ``"queued"`` / ``"preempted"`` on its worker,
        ``"displaced"`` while failover has no home for it, ``"closed"``."""
        return self.router.status(sid)

    def close_stream(self, sid: int):
        """Finalize a session; returns its ``CountResult`` (idempotent)."""
        return self.router.close(sid)

    def serve_streams(self, requests, *, block_size: int | None = None) -> list:
        """Serve many ``(n_nodes, blocks)`` requests concurrently across
        the cluster, round-robin interleaved — ``TriangleServer``'s
        signature, placement decided per session."""
        its = [iter(blocks) for _, blocks in requests]
        sids = [self.router.open(n, block_size=block_size)
                for n, _ in requests]
        live = set(range(len(requests)))
        while live:
            for i in sorted(live):
                try:
                    block = next(its[i])
                except StopIteration:
                    live.discard(i)
                    continue
                self.router.feed(sids[i], block)
        return [self.router.close(sid) for sid in sids]

    # -- cluster-only controls ---------------------------------------------
    def checkpoint_stream(self, sid: int) -> str | None:
        """Durability barrier: spill the session's state to the checkpoint
        dir and truncate its replay journal."""
        return self.router.checkpoint(sid)

    def migrate_stream(self, sid: int, to: int | None = None) -> int:
        """Move a live session to another worker (checkpoint → evict →
        restore; bit-identical, zero new traces on a warm target)."""
        return self.router.migrate(sid, to=to)

    def rebalance(self, *, threshold_bytes: int = 0) -> int | None:
        """One gap-shrinking migration between the most- and least-loaded
        workers (``None`` when already balanced)."""
        return self.router.rebalance(threshold_bytes=threshold_bytes)

    def stats(self) -> dict:
        """Router counters + per-worker ledger/multiplexer gauges."""
        return self.router.stats()

    def shutdown(self) -> None:
        self.router.shutdown()

    def __enter__(self) -> "ClusterServer":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
