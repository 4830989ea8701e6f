"""Session router: byte-charged placement, migration, and failover.

The router is the cluster front door. It owns the GLOBAL session ids and
a per-worker ``charged_bytes`` ledger, and delegates every placement
decision to the planner (:func:`repro_torch.api.place_session` —
least-loaded-by-bytes among the workers whose mesh-aware admission says
the session fits; queue/reject verdicts surface as
``BackpressureError``/``ValueError`` at ``open``). The ledger is the
Afrati–Ullman accounting made operational: a worker's load is the SUM of
its sessions' planner-predicted state bytes, nothing else, so the
property "charged == Σ predicted" is checkable at any moment (and tested).
The router also records the plan each placed session runs under, so a
``cuda`` worker's verdict is taken under the card's reserve its
multiplexer charges (``WorkerLoad.sessions``) and the router never places
a session that the worker would queue.

Durability is a checkpoint file plus a replay journal per session. Every
``feed``/``advance`` is journaled with a monotonically increasing ``seq``
BEFORE it goes on the wire; ``checkpoint(gid)`` spills the live session's
compressed snapshot (non-destructive, worker-side) and truncates the
journal up to that seq. Recovery is therefore mechanical:

- **migration** (``migrate``): evict on the source (checkpoint + forget),
  restore on the target, journal already empty past the checkpoint —
  bit-identical state, zero new traces when the target has seen the
  session's block shape.
- **failover** (worker connection lost): every session of the dead worker
  is re-placed on the survivors — checkpoint restore + replay of
  journal entries past the checkpoint's seq, or a fresh open + FULL
  journal replay when the session was never checkpointed. Workers apply
  replayed seqs exactly-once, so re-sending the whole tail is safe.
  Sessions no survivor can host become DISPLACED: their feeds keep
  journaling (bounded) and every later op retries placement, so capacity
  freed by a close lets them land — degradation, not loss.

Results are the port's ``CountResult``: the count arrives as a raw int64
buffer and is held as a CPU tensor, read with ``.item()``.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile

from repro_torch.serve.cluster.client import WorkerClient
from repro_torch.serve.cluster.protocol import WorkerDied


@dataclasses.dataclass
class _Placed:
    """Router-side record of one global session."""

    gid: int
    n_nodes: int
    window: int | None
    block_size: int | None
    priority: int
    worker: int | None = None    # None = displaced (no live home right now)
    wsid: int | None = None      # the worker's local sid
    state_bytes: int = 0         # planner-predicted bytes charged to worker
    plan: object = None          # the Plan it runs under there, at its block size
    seq: int = 0                 # last op seq issued (feeds + advances)
    ckpt_seq: int = -1           # ops ≤ this live in the checkpoint file
    ckpt_path: str | None = None
    journal: list = dataclasses.field(default_factory=list)
    journal_bytes: int = 0


class ClusterRouter:
    """Route stream sessions across worker processes (see module doc).

    ``workers`` may be pre-spawned :class:`WorkerClient`\\ s or spec dicts
    (``{"memory_bytes": ..., "devices": ..., "device": ...}``, the keywords
    of :meth:`WorkerClient.spawn`) spawned here, with their logs in the
    checkpoint directory; if one fails to start, those already spawned
    here are killed. ``checkpoint_dir`` is the shared directory checkpoint
    files live in (a private temp dir by default);
    ``checkpoint_every_bytes`` makes the router auto-checkpoint a session
    whenever its replay journal grows past that many buffered edge bytes,
    bounding both the journal and the replay a failover pays.
    ``journal_budget_bytes`` bounds the journal a DISPLACED session may
    accumulate before ``feed`` raises ``BackpressureError``."""

    def __init__(self, workers, *, checkpoint_dir: str | None = None,
                 checkpoint_every_bytes: int | None = 1 << 20,
                 journal_budget_bytes: int = 64 << 20):
        if not workers:
            raise ValueError("a cluster needs at least one worker")
        self._owns_dir = checkpoint_dir is None
        self.checkpoint_dir = checkpoint_dir or tempfile.mkdtemp(
            prefix="repro-cluster-")
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        self.workers: list[WorkerClient | None] = []
        spawned = []
        try:
            for w in workers:
                if not isinstance(w, WorkerClient):
                    w = WorkerClient.spawn(log_dir=self.checkpoint_dir, **w)
                    spawned.append(w)
                self.workers.append(w)
        except BaseException:
            for w in spawned:
                w.kill()
            raise
        self._charged = [0] * len(self.workers)
        self.checkpoint_every_bytes = checkpoint_every_bytes
        self.journal_budget_bytes = int(journal_budget_bytes)
        self._sessions: dict[int, _Placed] = {}
        self._results: dict[int, object] = {}
        self._next_gid = 0
        self.stats_counters = {"migrations": 0, "worker_deaths": 0,
                               "resurrections": 0, "checkpoints": 0,
                               "rejections": 0}

    # -- placement ---------------------------------------------------------
    def _loads(self, block_size: int | None = None):
        """(planner ``WorkerLoad`` list, parallel worker-index list) over
        the LIVE workers — dead slots stay in ``self.workers`` so worker
        indices are stable for the life of the router. Each load carries
        the worker's sessions and the block size it would run a session
        opened with ``block_size`` at, for the card's reserve."""
        from repro_torch.api import WorkerLoad

        loads, idx = [], []
        for i, w in enumerate(self.workers):
            if w is not None and w.alive:
                loads.append(WorkerLoad(
                    resources=w.resources, charged_bytes=self._charged[i],
                    mesh_devices=w.mesh_devices,
                    sessions=tuple((r.n_nodes, r.plan)
                                   for r in self._sessions.values()
                                   if r.worker == i),
                    block_size=block_size if block_size is not None
                    else w.block_size))
                idx.append(i)
        return loads, idx

    @staticmethod
    def _run_plan(adm, load):
        """The plan a worker runs a session admitted by ``adm`` under: the
        admission's, at the block size ``load`` says the worker takes."""
        return dataclasses.replace(
            adm.plan, block_size=int(load.block_size or adm.plan.block_size))

    def open(self, n_nodes: int, *, block_size: int | None = None,
             window: int | None = None, priority: int = 0) -> int:
        """Place one more stream session; returns its GLOBAL session id.

        The planner's placement verdict is enforced at this front door:
        ``reject`` (fits no worker even idle) raises ``ValueError``,
        ``queue`` (fits none at current load) raises ``BackpressureError``
        — callers retry after closing sessions; the router never buffers
        an unplaced open."""
        from repro_torch.api import place_session
        from repro_torch.api.planner import BackpressureError

        loads, idx = self._loads(block_size)
        pl = place_session(n_nodes, loads, window_epochs=window or 0)
        if pl.action == "reject":
            self.stats_counters["rejections"] += 1
            raise ValueError(pl.reason)
        if pl.action == "queue":
            raise BackpressureError(pl.reason)
        widx = idx[pl.worker]
        w = self.workers[widx]
        try:
            reply, _ = w.rpc({"op": "open", "n_nodes": int(n_nodes),
                              "block_size": block_size, "window": window,
                              "priority": priority})
        except WorkerDied:
            self._on_death(widx)
            return self.open(n_nodes, block_size=block_size, window=window,
                             priority=priority)
        gid = self._next_gid
        self._next_gid += 1
        self._sessions[gid] = _Placed(
            gid=gid, n_nodes=int(n_nodes), window=window,
            block_size=block_size, priority=int(priority), worker=widx,
            wsid=reply["sid"], state_bytes=pl.state_bytes,
            plan=self._run_plan(pl.admission, loads[pl.worker]))
        self._charged[widx] += pl.state_bytes
        return gid

    # -- session ops -------------------------------------------------------
    def _rec(self, gid: int) -> _Placed:
        if gid in self._sessions:
            return self._sessions[gid]
        if gid in self._results:
            raise RuntimeError(f"session {gid} already closed")
        raise KeyError(f"unknown session {gid}")

    def feed(self, gid: int, edges) -> None:
        """Feed one (B, 2) edge block: validated here, journaled with the
        next seq, then sent — so a worker lost mid-call costs nothing (the
        failover replay carries the block). A displaced session's feeds
        journal against ``journal_budget_bytes`` while every call retries
        placement."""
        from repro_torch.api.planner import BackpressureError
        from repro_torch.core import streaming

        rec = self._rec(gid)
        arr = streaming.validate_edges(edges, rec.n_nodes)
        if (rec.worker is None
                and rec.journal_bytes + arr.nbytes > self.journal_budget_bytes):
            raise BackpressureError(
                f"displaced session {gid} journal budget exhausted: "
                f"{arr.nbytes} B over {rec.journal_bytes}/"
                f"{self.journal_budget_bytes} B — close sessions to free a "
                f"worker, then retry")
        rec.seq += 1
        rec.journal.append(("feed", arr, rec.seq))
        rec.journal_bytes += arr.nbytes
        self._dispatch(rec, "feed", {"sid": rec.wsid, "seq": rec.seq},
                       {"edges": arr})
        self._maybe_autocheckpoint(rec)

    def advance(self, gid: int) -> None:
        """Slide a windowed session's window one epoch (journaled as an
        epoch marker, replayed in order on recovery)."""
        rec = self._rec(gid)
        rec.seq += 1
        rec.journal.append(("advance", None, rec.seq))
        self._dispatch(rec, "advance", {"sid": rec.wsid, "seq": rec.seq})

    def _dispatch(self, rec: _Placed, op: str, header: dict,
                  arrays: dict | None = None) -> None:
        """Send one already-journaled session op. Displaced sessions first
        retry placement (landing replays the journal, including this op);
        a worker death mid-send is absorbed the same way — the journal IS
        the op's durability, the RPC just its fast path."""
        if rec.worker is None:
            self._try_place(rec)
            return  # placed ⇒ journal replay applied it; displaced ⇒ parked
        w = self.workers[rec.worker]
        try:
            w.rpc({"op": op, **header}, arrays)
        except WorkerDied:
            self._on_death(rec.worker)

    def _maybe_autocheckpoint(self, rec: _Placed) -> None:
        if (self.checkpoint_every_bytes is not None and rec.worker is not None
                and rec.journal_bytes >= self.checkpoint_every_bytes):
            self.checkpoint(rec.gid)

    def checkpoint(self, gid: int) -> str | None:
        """Durability barrier: compressed-spill ``gid``'s live state to the
        checkpoint dir (non-destructive — the session keeps serving) and
        truncate its replay journal. Returns the file path (``None`` for a
        displaced session, whose journal is already its full record)."""
        rec = self._rec(gid)
        if rec.worker is None:
            return None
        path = self._ckpt_path(gid)
        try:
            self.workers[rec.worker].rpc(
                {"op": "checkpoint", "sid": rec.wsid, "path": path})
        except WorkerDied:
            self._on_death(rec.worker)
            return self.checkpoint(gid) if rec.worker is not None else None
        rec.ckpt_path, rec.ckpt_seq = path, rec.seq
        rec.journal, rec.journal_bytes = [], 0
        self.stats_counters["checkpoints"] += 1
        return path

    def close(self, gid: int):
        """Finalize ``gid`` and return its ``CountResult`` (idempotent).
        The count crosses the wire as a raw buffer, so value AND dtype are
        bit-identical to a single-process close. A displaced session whose
        checkpoint already covers every journaled op finalizes host-side
        from the file (zero worker cost); one with unreplayed ops needs a
        worker and raises ``BackpressureError`` when none can host it."""
        import torch

        from repro_torch.api import CountResult, Plan, SessionCheckpoint
        from repro_torch.api.planner import BackpressureError

        if gid in self._results:
            return self._results[gid]
        rec = self._rec(gid)
        if rec.worker is None:
            pending = [e for e in rec.journal if e[2] > rec.ckpt_seq]
            if rec.ckpt_path is not None and not pending:
                result = SessionCheckpoint.from_file(
                    rec.ckpt_path).finalize_result()
                result.stats["worker"] = None
                return self._finish(rec, result)
            self._try_place(rec)
            if rec.worker is None:
                raise BackpressureError(
                    f"cannot close displaced session {gid}: "
                    f"{len(pending) if rec.ckpt_path else len(rec.journal)} "
                    f"journaled op(s) need a worker and none can host its "
                    f"state — close other sessions first")
        w = self.workers[rec.worker]
        try:
            reply, arrays = w.rpc({"op": "close", "sid": rec.wsid})
        except WorkerDied:
            self._on_death(rec.worker)
            return self.close(gid)
        # a 0-d count crosses the wire as one element (the frame format's)
        result = CountResult(count=torch.from_numpy(arrays["count"]).reshape(()),
                             plan=(Plan.from_dict(reply["plan"])
                                   if reply["plan"] is not None else None),
                             wall_s=reply["wall_s"], stats=reply["stats"])
        result.stats["worker"] = rec.worker
        self._charged[rec.worker] -= rec.state_bytes
        return self._finish(rec, result)

    def _finish(self, rec: _Placed, result):
        del self._sessions[rec.gid]
        if rec.ckpt_path is not None and os.path.exists(rec.ckpt_path):
            os.remove(rec.ckpt_path)
        self._results[rec.gid] = result
        return result

    def status(self, gid: int) -> str:
        """``"closed"``, ``"displaced"``, or the hosting worker's own
        verdict (``"active"`` / ``"queued"`` / ``"preempted"``)."""
        if gid in self._results:
            return "closed"
        rec = self._rec(gid)
        if rec.worker is None:
            return "displaced"
        try:
            reply, _ = self.workers[rec.worker].rpc(
                {"op": "status", "sid": rec.wsid})
        except WorkerDied:
            self._on_death(rec.worker)
            return "displaced" if rec.worker is None else self.status(gid)
        return reply["status"]

    def worker_of(self, gid: int) -> int | None:
        """Which worker index hosts ``gid`` now (``None`` = displaced)."""
        return self._rec(gid).worker

    # -- migration / failover ---------------------------------------------
    def migrate(self, gid: int, to: int | None = None) -> int:
        """Move live session ``gid`` to another worker NOW: checkpoint +
        evict on the source, restore on the target — the state arrives
        bit-identical and the restore retraces nothing the target has
        already compiled. Target is ``to`` or the least-loaded other
        worker whose admission accepts; raises ``BackpressureError`` when
        no target fits (the session stays where it is)."""
        from repro_torch.api import worker_admission
        from repro_torch.api.planner import BackpressureError

        rec = self._rec(gid)
        if rec.worker is None:
            self._try_place(rec)
            if rec.worker is None:
                raise BackpressureError(
                    f"displaced session {gid} still fits no worker")
            return rec.worker
        src = rec.worker
        if to == src:
            raise ValueError(f"session {gid} already lives on worker {src}")
        loads, idx = self._loads(rec.block_size)
        target, target_bytes = None, 0
        order = sorted(range(len(loads)),
                       key=lambda li: (loads[li].charged_bytes, idx[li]))
        for li in order:
            wi = idx[li]
            if wi == src or (to is not None and wi != to):
                continue
            adm = worker_admission(rec.n_nodes, loads[li],
                                   window_epochs=rec.window or 0)
            if adm.admitted:
                target, target_bytes = wi, adm.state_bytes
                break
        if target is None:
            raise BackpressureError(
                f"no worker can host session {gid} ({rec.n_nodes} nodes) "
                f"for migration off worker {src}")
        path = self._ckpt_path(gid)
        try:
            self.workers[src].rpc(
                {"op": "evict", "sid": rec.wsid, "path": path})
        except WorkerDied:
            self._on_death(src)  # failover already re-placed the session
            return rec.worker if rec.worker is not None else -1
        self._charged[src] -= rec.state_bytes
        rec.worker, rec.wsid = None, None
        rec.ckpt_path, rec.ckpt_seq = path, rec.seq
        rec.journal, rec.journal_bytes = [], 0
        try:
            reply, _ = self.workers[target].rpc(
                {"op": "restore", "path": path, "seq": rec.seq,
                 "priority": rec.priority})
        except (WorkerDied, BackpressureError):
            if not self.workers[target].alive:
                self._on_death(target)
            self._try_place(rec)  # land it anywhere that fits
            if rec.worker is None:
                raise
            return rec.worker
        rec.worker, rec.wsid, rec.state_bytes = (
            target, reply["sid"], target_bytes)
        self._charged[target] += target_bytes
        self.stats_counters["migrations"] += 1
        return target

    def rebalance(self, *, threshold_bytes: int = 0) -> int | None:
        """One load-balancing step: when the charged-bytes gap between the
        most- and least-loaded live workers exceeds ``threshold_bytes``,
        migrate the largest gap-shrinking session across. Returns the
        migrated gid or ``None`` (already balanced / nothing movable)."""
        from repro_torch.api.planner import BackpressureError

        live = [(i, self._charged[i]) for i, w in enumerate(self.workers)
                if w is not None and w.alive]
        if len(live) < 2:
            return None
        hi = max(live, key=lambda t: (t[1], t[0]))
        lo = min(live, key=lambda t: (t[1], t[0]))
        gap = hi[1] - lo[1]
        if gap <= threshold_bytes:
            return None
        movable = sorted(
            (r for r in self._sessions.values() if r.worker == hi[0]
             and r.state_bytes < gap),  # moving must shrink the imbalance
            key=lambda r: (-r.state_bytes, r.gid))
        for r in movable:
            try:
                self.migrate(r.gid, to=lo[0])
            except (BackpressureError, ValueError):
                continue
            return r.gid
        return None

    def _on_death(self, widx: int) -> None:
        """Failure handling for one lost worker connection: reap the
        process, zero its ledger, and resurrect every session it hosted on
        the survivors (checkpoint + journal replay). Unplaceable sessions
        become displaced, not lost."""
        w = self.workers[widx]
        if w is None:
            return
        w.kill()
        self.workers[widx] = None
        self._charged[widx] = 0
        self.stats_counters["worker_deaths"] += 1
        orphans = [r for r in self._sessions.values() if r.worker == widx]
        for r in orphans:
            r.worker, r.wsid = None, None
        for r in orphans:
            self._try_place(r)

    def _try_place(self, rec: _Placed) -> None:
        """Find a live home for a displaced session and rebuild its state
        there: checkpoint restore + replay of journal entries past the
        checkpoint seq, or a fresh open + full journal replay when it was
        never checkpointed. Workers dedup replayed seqs, so replaying a
        tail the dead worker already applied cannot double-count."""
        from repro_torch.api import worker_admission
        from repro_torch.api.planner import BackpressureError

        loads, idx = self._loads(rec.block_size)
        order = sorted(range(len(loads)),
                       key=lambda li: (loads[li].charged_bytes, idx[li]))
        for li in order:
            wi = idx[li]
            adm = worker_admission(rec.n_nodes, loads[li],
                                   window_epochs=rec.window or 0)
            if not adm.admitted:
                continue
            w = self.workers[wi]
            try:
                plan = rec.plan  # a checkpoint restores the plan it ran under
                if rec.ckpt_path is not None:
                    reply, _ = w.rpc({"op": "restore", "path": rec.ckpt_path,
                                      "seq": rec.ckpt_seq,
                                      "priority": rec.priority})
                    wsid = reply["sid"]
                    replay = [e for e in rec.journal if e[2] > rec.ckpt_seq]
                else:
                    plan = self._run_plan(adm, loads[li])
                    reply, _ = w.rpc({"op": "open", "n_nodes": rec.n_nodes,
                                      "block_size": rec.block_size,
                                      "window": rec.window,
                                      "priority": rec.priority})
                    wsid = reply["sid"]
                    replay = list(rec.journal)
                for kind, arr, seq in replay:
                    if kind == "feed":
                        w.rpc({"op": "feed", "sid": wsid, "seq": seq},
                              {"edges": arr})
                    else:
                        w.rpc({"op": "advance", "sid": wsid, "seq": seq})
            except WorkerDied:
                self._on_death(wi)
                return  # survivors already retried via _on_death's loop
            except BackpressureError:
                continue
            rec.worker, rec.wsid, rec.state_bytes = wi, wsid, adm.state_bytes
            rec.plan = plan
            self._charged[wi] += adm.state_bytes
            self.stats_counters["resurrections"] += 1
            return

    # -- introspection / lifecycle ----------------------------------------
    def charged_bytes(self) -> list[int]:
        """The per-worker ledger: planner-predicted bytes charged per
        worker index (0 for dead slots)."""
        return list(self._charged)

    def stats(self) -> dict:
        """Cluster snapshot: router counters, sessions in flight, and each
        worker's own ``stats`` reply (ledger bytes, multiplexer gauges,
        process-wide ingest trace count)."""
        per_worker = []
        for i, w in enumerate(self.workers):
            if w is None or not w.alive:
                per_worker.append({"alive": False})
                continue
            try:
                reply, _ = w.rpc({"op": "stats"})
            except WorkerDied:
                self._on_death(i)
                per_worker.append({"alive": False})
                continue
            reply.pop("ok", None)
            per_worker.append({"alive": True,
                               "charged_bytes": self._charged[i], **reply})
        return {**self.stats_counters,
                "sessions": len(self._sessions),
                "displaced": sum(r.worker is None
                                 for r in self._sessions.values()),
                "workers": per_worker}

    def shutdown(self) -> None:
        """Stop every worker (graceful, then kill) and remove the
        checkpoint dir if this router created it."""
        for w in self.workers:
            if w is not None:
                w.shutdown()
        if self._owns_dir and os.path.isdir(self.checkpoint_dir):
            for name in os.listdir(self.checkpoint_dir):
                try:
                    os.remove(os.path.join(self.checkpoint_dir, name))
                except OSError:
                    pass
            try:
                os.rmdir(self.checkpoint_dir)
            except OSError:
                pass

    def __enter__(self) -> "ClusterRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def _ckpt_path(self, gid: int) -> str:
        return os.path.join(self.checkpoint_dir, f"session-{gid}.npz")
