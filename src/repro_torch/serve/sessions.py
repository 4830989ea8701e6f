"""Concurrent multi-stream serving: many ``StreamSession``s, one budget,
and a PREEMPTIBLE fair-share scheduler on top — the reference's
``repro.serve.sessions`` on one device of PyTorch.

The :class:`StreamMultiplexer` holds any number of open sessions,
interleaves block ingest across them, and shares the server's ONE
``TriangleCounter``, so S concurrent streams feeding one block shape record
one ingest key.

The memory story is the planner's (``api.planner.admit_session``): each
active session pins its adjacency-so-far bitset — n²/8 bytes dense, ×E for
a sliding-window session of E epoch bitsets, the linear-in-n hybrid state
past the bitset's reach — and the multiplexer accounts those pinned bytes
against ``Resources.memory_bytes``. A ring-sharded state is charged
n²/8/S only where the counter's mesh hosts the ring one stage per device,
as in the reference (``api.planner.mesh_admission``); an emulated-sharded
state is charged in full, and so is a mesh state whose stages share one
card, since its shards add up there (``device_state_bytes``). The planner
never picks such a ring; ``open(plan=)`` runs a session under the caller's
plan instead, charged what that plan pins (``plan_admission``). Residency
is a SCHEDULING decision, not a permanent grant:

- **Fair share + preemption** (``policy="fair"``, the default): every
  session opens with a ``priority=`` (higher runs first; default 0). A
  higher-priority ``open`` that would otherwise queue instead PREEMPTS
  strictly-lower-priority actives — ``StreamSession.checkpoint()`` parks
  their state host-side in a bounded :class:`CheckpointStore` (spilling to
  compressed ``.npz`` under ``spill_dir`` past the host budget) and
  ``TriangleCounter.restore_stream`` readmits them bit-identically once
  budget frees. Equal priorities never preempt each other.
  ``policy="fifo"`` disables priorities and preemption outright.
- **Bounded backpressure**: a waiting session's feeds buffer host-side
  (numpy; window advances buffer as epoch markers) up to
  ``queue_budget_bytes`` ACROSS all waiters; past it ``feed`` raises
  :class:`~repro_torch.api.planner.BackpressureError`. The checkpoint store
  is bounded the same way (``checkpoint_budget_bytes`` host +
  ``spill_budget_bytes`` disk).
- **Deadlines**: ``open(..., deadline_s=T)`` reaps a session idle longer
  than T (on the injectable ``clock``) — an abandoned ACTIVE stream is
  checkpointed off the device (a late ``close`` still recovers the true
  count), and if it stays idle another T (or the store is full) it is
  cancelled outright. A request that could never fit even on an idle
  server is rejected at ``open``.

THE CARD'S RESERVE. On a ``cuda`` counter an ingest allocates scratch
beside the states — the block's (n, W) delta table (8.73 GB at NY), the
gathered rows of a hybrid block, the in-flight blocks — which the
reference's admission does not charge. Admitting by state bytes alone
against the card's whole memory would let the first ingest run the card
out of memory, so on the card the multiplexer takes every admission
against ``memory_bytes`` less ``api.planner.card_reserve_bytes`` of the
active sessions and the candidate (a pure function of their (n, plan)
pairs). Off the card the reserve is 0 and every verdict is the reference's.
A closing or evicted session drops its state before the freed budget
admits a waiter, so on the card the memory is free when the waiter
allocates. Free is not contiguous, though: under a mixed order of opens,
preemptions and closes of multi-GB states, the caching allocator's fixed
segments fragment until an 8.73 GB delta table finds no block beside
8.5 GiB of free fragments (an NVIDIA H100 80GB HBM3 at 700 W,
``chip_smoke.py`` [serve streams] (f)). So the first session a multiplexer
on the card activates turns the allocator's expandable segments on for the
process (:func:`expandable_segments`), which map freed pages to any later
request; a process that turned them off explicitly is refused.

ASYNC PREFETCH (``prefetch_depth=K``): each active session gets a
:class:`_PrefetchDriver` — one background ``PropagatingThread`` that owns
the session's host half (``StreamSession.reblock``: re-blocking, padding and
the host-to-device copy) and hands device-ready blocks to the drive thread
through a BOUNDED queue of depth K. The drive thread only dispatches
ingest, so host re-blocking of block i+1 overlaps the device's ingest of
block i. Both queues are bounded (K and 2K), every blocking wait is
watchdog-bounded (``_PrefetchDriver._JOIN_TIMEOUT``), and producer
exceptions propagate to the drive thread at the next submit/barrier via
``PropagatingThread.join``. Because both queues are FIFO and one thread
owns each half, the device-op sequence is IDENTICAL to the synchronous
path: async counts and checkpoints are bit-identical to sync. Scheduling
points that need the exact synchronous state (checkpoint, preempt, evict,
close) BARRIER the driver first; ``kill()`` drops in-flight blocks without
ever blocking past the watchdog.

STREAMS ON THE CARD. The producer queues each block's copy from pinned
memory (``non_blocking``) on the device's default stream, the stream the
drive thread's ingests run on. A block reaches the drive thread only after
its copy was queued, so the copy is ordered before the ingest that reads
it; and the caching allocator hands a freed block's memory only to later
work on that same stream, so it cannot be reused before the ingest ran. No
side stream, so no event and no ``record_stream`` is needed. The ingest
never waits for the card; a checkpoint's snapshot does (it copies to the
host).

Single-driver concurrency: the multiplexer itself is driven from one
thread (the serve loop); the prefetch threads it owns never touch scheduler
state — they speak to their session only through the public producer-half
API (``reblock``/``flush_ready``/``set_block_size``).
"""
from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.utils import PropagatingThread, count_dtype


def expandable_segments() -> None:
    """Turn the CUDA caching allocator's expandable segments on for this
    process: segments allocated from here on grow and shrink by pages, so a
    multi-GB request finds the memory that closed sessions freed, wherever
    it lies. The multiplexer's admission promises that an admitted session
    fits beside the others, and fixed segments break that promise under a
    mixed order of opens and closes. Raises ``RuntimeError`` when the
    process's ``PYTORCH_CUDA_ALLOC_CONF`` (or ``PYTORCH_ALLOC_CONF``) turned
    them off explicitly; leaves the ``cudaMallocAsync`` backend, which has
    no such segments, as it is."""
    for var in ("PYTORCH_CUDA_ALLOC_CONF", "PYTORCH_ALLOC_CONF"):
        conf = os.environ.get(var, "").replace(" ", "").lower()
        if "expandable_segments:false" in conf:
            raise RuntimeError(
                f"{var}={os.environ[var]!r} turns expandable segments off: a stream "
                f"multiplexer on the card needs them, since fixed segments fragment "
                f"until an admitted session finds no block")
    if torch.cuda.get_allocator_backend() != "native":
        return
    setting = getattr(torch._C, "_accelerator_setAllocatorSettings", None) \
        or torch.cuda.memory._set_allocator_settings
    setting("expandable_segments:True")


# Epoch marker in a waiting session's host-side buffer: replayed as advance()
# so a windowed request admitted late still sees its epoch boundaries.
_ADVANCE = "advance"


@dataclasses.dataclass
class _Session:
    """One scheduler record, live for the session's whole non-closed life.

    ``state`` is ``"queued"`` (never admitted; no device state, no
    checkpoint) → ``"active"`` (``session`` is the live ``StreamSession``,
    ``state_bytes`` pinned) ⇄ ``"preempted"`` (device state parked in the
    ``CheckpointStore``; ``state_bytes`` is what readmission will re-pin) →
    closed (record dropped, result cached). ``plan`` is the plan the
    session runs, at its block size and the multiplexer's prefetch depth
    (what the card's reserve is computed from), set once it is admitted."""

    sid: int
    n_nodes: int
    block_size: int | None
    window: int | None
    priority: int
    deadline_s: float | None
    last_activity: float
    state: str = "queued"
    session: object | None = None
    blocks: list = dataclasses.field(default_factory=list)
    buffered_bytes: int = 0
    state_bytes: int = 0
    n_preempts: int = 0
    served_blocks: int = 0
    plan: object | None = None
    # the plan the caller opened it with (open(plan=)), None for the planner's
    asked: object | None = None
    # live async prefetch pipeline (None on the synchronous path or while
    # the session is waiting — drivers exist only for ACTIVE sessions)
    driver: object | None = None
    # parked = deliberately benched (explicit preempt / deadline reap): the
    # scheduler leaves it out of readmission sweeps until new activity marks
    # it live again (or close() forces the restore). Victims of a
    # priority-preemption are NOT parked — they readmit transparently.
    parked: bool = False
    # perf_counter_ns when open() queued it, the start of its mux.queued span
    queued_ns: int | None = None


class _PrefetchDriver:
    """Per-session async prefetch pipeline: a producer thread re-blocks raw
    edges into device-ready padded blocks; the drive thread only dispatches
    ingest.

    OWNERSHIP. The producer thread owns the session's HOST half — it is the
    only caller of ``reblock``/``flush_ready``/``set_block_size`` (every
    BlockBuffer mutation and host-to-device copy, guarded by the buffer's
    SPSC lock). The drive thread owns the DEVICE half — it is the only
    caller of ``ingest_ready``/``expire_ready``. Commands flow producer-ward
    through ``_in`` (bounded at 2·depth); device-ready blocks flow back
    through ``_ready`` (bounded at ``depth``). Both queues are FIFO and each
    half is single-threaded, so the device-op sequence is exactly the
    synchronous one.

    DEADLOCK FREEDOM. Every blocking wait is bounded: the drive thread pumps
    ``_ready`` while waiting for ``_in`` space, the producer drops its
    output when killed, and every loop carries a ``_JOIN_TIMEOUT`` watchdog
    that raises instead of hanging. Producer exceptions are re-raised on the
    drive thread by ``PropagatingThread.join`` at the next
    submit/barrier/shutdown.

    LIFECYCLE. ``barrier()`` drains the whole pipeline — after it the
    session state is bit-identical to a synchronous driver's.
    ``shutdown()`` is barrier-then-join; ``kill()`` drops in-flight blocks,
    wakes and joins the thread within the watchdog, and never raises."""

    _JOIN_TIMEOUT = 30.0  # seconds; tests shrink this to fail fast

    def __init__(self, session, depth: int, *, adaptive: bool = False,
                 jitter=None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.session = session
        self.depth = int(depth)
        self._in = queue.Queue(maxsize=2 * self.depth)
        self._ready = queue.Queue(maxsize=self.depth)
        # in-flight accounting for the barrier fast path: the drive thread
        # bumps _n_submitted per command, the producer bumps _n_done AFTER a
        # command's outputs are all in _ready — equal counters + empty ready
        # queue means the pipeline is quiescent (single submitter, GIL-atomic
        # int bumps)
        self._n_submitted = 0
        self._n_done = 0
        self._dead = False
        self._jitter = jitter          # test hook: seeded timing perturbation
        self._pending_resize = None
        if adaptive:
            from repro_torch.core import streaming

            self._sizer = streaming.AdaptiveBlockSizer(session.block_size)
        else:
            self._sizer = None
        self._thread = PropagatingThread(
            target=self._produce, name=f"prefetch-{id(session):x}",
            daemon=True)
        self._thread.start()

    # -- producer thread ---------------------------------------------------
    def _produce(self) -> None:
        while not self._dead:
            kind, payload = self._in.get()
            if kind == "stop":
                return
            if self._jitter is not None:
                self._jitter()
            if kind == "edges":
                for b in self.session.reblock(payload):
                    self._put_ready(("block", b))
            elif kind == "advance":
                # flush the closing epoch's tail BEFORE the expiry marker so
                # the consumer replays exactly the synchronous order
                tail = self.session.flush_ready()
                if tail is not None:
                    self._put_ready(("block", tail))
                self._put_ready(("advance", None))
            elif kind == "resize":
                for b in self.session.set_block_size(payload):
                    self._put_ready(("block", b))
            elif kind == "sync":
                self._put_ready(("sync", payload))
            self._n_done += 1  # outputs are queued: the command is done

    def _put_ready(self, item) -> None:
        while not self._dead:
            try:
                self._ready.put(item, timeout=0.05)
                return
            except queue.Full:
                continue

    # -- drive (consumer) thread -------------------------------------------
    def submit(self, edges) -> None:
        """Enqueue one validated (B, 2) edge array for background
        re-blocking, then dispatch whatever blocks are already device-ready.
        Blocks (watchdog-bounded) only when the whole pipeline is full — and
        then it drains ``_ready`` while waiting."""
        if self._pending_resize is not None:
            size, self._pending_resize = self._pending_resize, None
            self._submit(("resize", size))
        self._submit(("edges", edges))
        self.pump()

    def advance(self) -> None:
        """Enqueue an epoch boundary (tail flush + window slide), in order
        with the edges submitted around it."""
        self._submit(("advance", None))
        self.pump()

    def _submit(self, item) -> None:
        deadline = time.monotonic() + self._JOIN_TIMEOUT
        while True:
            self._check_producer()
            try:
                self._in.put(item, timeout=0.02)
                self._n_submitted += 1
                return
            except queue.Full:
                self.pump()
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"prefetch watchdog: command queue still full after "
                        f"{self._JOIN_TIMEOUT}s — producer thread wedged?")

    def pump(self) -> None:
        """Dispatch every block that is device-ready RIGHT NOW
        (non-blocking: the producer keeps re-blocking meanwhile)."""
        while True:
            try:
                item = self._ready.get_nowait()
            except queue.Empty:
                return
            self._dispatch(item)

    def _dispatch(self, item) -> None:
        kind, payload = item
        if kind == "block":
            seconds = self.session.ingest_ready(payload)
            if self._sizer is not None:
                new = self._sizer.observe(len(payload), seconds)
                if new is not None:
                    self._pending_resize = new
        elif kind == "advance":
            self.session.expire_ready()
        else:  # sync marker
            payload.set()

    def barrier(self) -> None:
        """Drain the pipeline completely: returns with the producer idle,
        both queues empty and every submitted edge ingested — the session
        state is what a synchronous driver would hold. Raises (via the
        watchdog or the producer's propagated exception) instead of
        hanging."""
        if self._n_submitted == self._n_done:
            # fast path: every command finished, and an idle producer adds
            # nothing to _ready, so drain-and-return is race-free
            self.pump()
            if self._n_submitted == self._n_done and self._ready.empty():
                self._check_producer()
                return
        done = threading.Event()
        self._submit(("sync", done))
        deadline = time.monotonic() + self._JOIN_TIMEOUT
        while not done.is_set():
            self._check_producer()
            try:
                item = self._ready.get(timeout=0.05)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"prefetch watchdog: barrier not reached after "
                        f"{self._JOIN_TIMEOUT}s — producer thread wedged?")
                continue
            self._dispatch(item)

    def shutdown(self) -> None:
        """Graceful stop after a ``barrier()``: the producer exits and is
        joined (re-raising any stored exception); raises if it will not die
        within the watchdog."""
        self._submit(("stop", None))
        self._thread.join(self._JOIN_TIMEOUT)
        if self._thread.is_alive():
            raise RuntimeError(
                f"prefetch watchdog: producer thread failed to stop within "
                f"{self._JOIN_TIMEOUT}s")

    def kill(self) -> None:
        """SIGKILL analogue: drop all in-flight work (raw AND device-ready
        blocks), wake the producer however it is blocked, and join it.
        Swallows producer exceptions — the session is being destroyed — and
        never blocks past the watchdog."""
        self._dead = True
        deadline = time.monotonic() + self._JOIN_TIMEOUT
        while self._thread.is_alive() and time.monotonic() < deadline:
            try:  # discard raw items / make room for the stop pill
                self._in.get_nowait()
            except queue.Empty:
                pass
            try:  # wake a producer blocked on _in.get()
                self._in.put_nowait(("stop", None))
            except queue.Full:
                pass
            try:  # unblock a producer stuck publishing to a full _ready
                self._ready.get_nowait()
            except queue.Empty:
                pass
            try:
                self._thread.join(0.02)
            except BaseException:
                pass  # propagated producer exception: the session is dead

    def _check_producer(self) -> None:
        """Fail fast if the producer died: join(0) re-raises its stored
        exception on THIS thread (the PropagatingThread contract)."""
        if not self._thread.is_alive():
            self._thread.join(0)
            raise RuntimeError(
                "prefetch producer thread exited unexpectedly")


class CheckpointStore:
    """Bounded parking lot for preempted sessions' checkpoints.

    Host memory first (up to ``host_budget_bytes`` of snapshot arrays), then
    COMPRESSED ``.npz`` spill files under ``spill_dir`` (up to
    ``spill_budget_bytes`` of actual on-disk bytes — sparse bitset rows
    deflate heavily, so the disk budget charges what the file really costs;
    default 4× the host budget when a spill dir is given, 0 otherwise).

    When the host budget is hit the store LRU-spills host-resident
    checkpoints to disk (oldest-parked first) until the new snapshot fits,
    and raises :class:`~repro_torch.api.planner.BackpressureError` only when
    the DISK budget is exhausted too. ``put_all`` is transactional: it
    places every checkpoint (and keeps every eviction) or rolls everything
    back, so a multi-victim preemption never half-commits.

    ``evict`` picks WHICH host-resident checkpoint spills first: ``"lru"``
    (default) walks parking order; ``"largest"`` spills the biggest
    host-resident snapshot first (fewest spill files for the freed bytes).
    Zlib runs at a few hundred MB/s, so a checkpoint of gigabytes (NY's 8.73
    GB bitset) belongs in the host tier: size ``host_budget_bytes`` for it."""

    def __init__(self, host_budget_bytes: int, *, spill_dir: str | None = None,
                 spill_budget_bytes: int | None = None, evict: str = "lru"):
        if evict not in ("lru", "largest"):
            raise ValueError(f"evict must be 'lru' or 'largest', got {evict!r}")
        self.host_budget_bytes = int(host_budget_bytes)
        self.evict = evict
        self.spill_dir = spill_dir
        if spill_budget_bytes is None:
            spill_budget_bytes = 4 * self.host_budget_bytes if spill_dir else 0
        self.spill_budget_bytes = int(spill_budget_bytes)
        self.host_bytes = 0
        self.spill_bytes = 0        # compressed on-disk bytes of live spills
        self.spill_raw_bytes = 0    # the uncompressed bytes those files hold
        self.n_spills = 0
        self.n_evictions = 0
        # sid -> [ckpt, "host"|"disk", charged_bytes]; dict order is
        # parking order, which is the LRU order evictions walk
        self._held: dict[int, list] = {}

    def __contains__(self, sid: int) -> bool:
        return sid in self._held

    def __len__(self) -> int:
        return len(self._held)

    @property
    def compression_ratio(self) -> float:
        """Raw/compressed over the LIVE spill files (1.0 when none)."""
        return (self.spill_raw_bytes / self.spill_bytes
                if self.spill_bytes else 1.0)

    def put_all(self, items) -> None:
        """Place every ``(sid, SessionCheckpoint)`` or raise without placing
        any — the all-or-nothing half of a multi-victim preemption. Host
        first; when the host budget is hit, evict host-resident checkpoints
        to compressed disk spills, then spill the incoming snapshot itself;
        raise only when the disk budget refuses too (any evictions already
        performed are rolled back)."""
        from repro_torch.api.planner import BackpressureError

        host_b, spill_b, raw_b = (self.host_bytes, self.spill_bytes,
                                  self.spill_raw_bytes)
        placement: list[tuple] = []  # per item: ("host"|"disk", charged)
        undo: list = []              # (sid, ckpt, held_entry|None, prev_charged)
        n_spills = n_evictions = 0

        def _spill(sid, ckpt):
            """Write the compressed file; return its size, or None (file
            removed again) when the disk budget refuses it. Its spans carry
            ``sid``."""
            nonlocal spill_b, raw_b, n_spills
            if self.spill_dir is None:
                return None
            os.makedirs(self.spill_dir, exist_ok=True)
            with tracing.session(sid):
                ckpt.spill(os.path.join(self.spill_dir, f"ckpt-{sid}.npz"))
                db = ckpt.disk_bytes
                if spill_b + db > self.spill_budget_bytes:
                    ckpt.load_arrays()  # reload + delete the just-written file
                    return None
            spill_b += db
            raw_b += ckpt.nbytes
            n_spills += 1
            return db

        try:
            for sid, ckpt in items:
                while host_b + ckpt.nbytes > self.host_budget_bytes:
                    vsid = self._victim()
                    if vsid is None:
                        break
                    victim = self._held[vsid]
                    db = _spill(vsid, victim[0])
                    if db is None:
                        break
                    host_b -= victim[2]
                    undo.append((vsid, victim[0], victim, victim[2]))
                    victim[1], victim[2] = "disk", db
                    n_evictions += 1
                if host_b + ckpt.nbytes <= self.host_budget_bytes:
                    host_b += ckpt.nbytes
                    placement.append(("host", ckpt.nbytes))
                    continue
                db = _spill(sid, ckpt)
                if db is not None:
                    placement.append(("disk", db))
                    undo.append((sid, ckpt, None, 0))
                    continue
                raise BackpressureError(
                    f"checkpoint store full: {ckpt.nbytes} B snapshot over "
                    f"host {self.host_bytes}/{self.host_budget_bytes} B and "
                    f"spill {self.spill_bytes}/{self.spill_budget_bytes} B "
                    f"({len(self._held)} checkpoint(s) parked) — close or "
                    f"restore a preempted session first")
        except BaseException:
            for sid, ckpt, entry, prev_charged in reversed(undo):
                with tracing.session(sid):
                    ckpt.load_arrays()  # reload host arrays, delete the file
                if entry is not None:  # evicted resident: back to host
                    entry[1], entry[2] = "host", prev_charged
            raise
        for (sid, ckpt), (where, charged) in zip(items, placement):
            self._held[sid] = [ckpt, where, charged]
        self.host_bytes, self.spill_bytes, self.spill_raw_bytes = \
            host_b, spill_b, raw_b
        self.n_spills += n_spills
        self.n_evictions += n_evictions

    def _victim(self) -> int | None:
        """The next host-resident sid to evict to disk, per ``self.evict``
        (None when nothing host-resident is left to spill)."""
        hosts = [(s, h) for s, h in self._held.items() if h[1] == "host"]
        if not hosts:
            return None
        if self.evict == "largest":
            # ties break toward parking order, keeping evictions stable
            return max(hosts, key=lambda sh: sh[1][2])[0]
        return hosts[0][0]  # lru: dict order IS parking order

    def put(self, sid: int, ckpt) -> None:
        self.put_all([(sid, ckpt)])

    def take(self, sid: int):
        """Remove and return ``sid``'s checkpoint (the restore half; loading
        a spilled checkpoint's arrays is the checkpoint's own job)."""
        ckpt, where, charged = self._held.pop(sid)
        if where == "host":
            self.host_bytes -= charged
        else:
            self.spill_bytes -= charged
            self.spill_raw_bytes -= ckpt.nbytes
        return ckpt

    def where(self, sid: int) -> str:
        """``"host"`` or ``"disk"`` — where ``sid``'s checkpoint lives now
        (evictions move parked checkpoints host → disk behind the scenes)."""
        return self._held[sid][1]

    def drop(self, sid: int) -> None:
        """Discard ``sid``'s checkpoint (cancelled session: the state is not
        coming back; removes the spill file if it was on disk)."""
        self.take(sid).discard()


class StreamMultiplexer:
    """Interleave block ingest across concurrent stream sessions, with
    fair-share scheduling, preemption, bounded backpressure, and deadlines.

    Lifecycle per request: ``open(n_nodes, priority=, deadline_s=) -> sid``
    (admitted, queued, or admitted-by-preempting lower-priority actives;
    ``window=E`` opens a sliding-window session), any number of
    ``feed(sid, edges)`` — and, for windowed sessions, ``advance(sid)`` — in
    any interleaving with other sessions, then ``close(sid) -> CountResult``
    (idempotent). ``status(sid)`` is ``"active"`` / ``"queued"`` /
    ``"preempted"`` / ``"closed"``. ``preempt(sid)`` parks an active session
    explicitly; ``next_sid()`` is the fair-share scheduling hint for drivers
    choosing which active session to feed next.

    Closing a session that never got admitted CANCELS it (buffers dropped,
    ``CountResult`` with ``stats["cancelled"]`` and a zero count on the
    counter's device); closing a PREEMPTED session restores it first so the
    count is exact.

    All sessions run over one :class:`~repro_torch.api.TriangleCounter`
    (``counter``, else a new one on ``device`` — ``cuda`` unless
    ``device="cpu"``). ``block_size`` is the uniform default applied to every
    session (overridable per ``open``). ``bytes_in_use`` is the sum of the
    ACTIVE sessions' pinned state, the only thing admission charges beside
    the card's reserve (``reserve_bytes``); every host-side byte
    (waiting-feed buffers, parked checkpoints, spill files) is bounded, and
    exhaustion raises :class:`~repro_torch.api.planner.BackpressureError`."""

    def __init__(self, counter=None, resources=None, *,
                 block_size: int | None = None, policy: str = "fair",
                 queue_budget_bytes: int | None = None,
                 checkpoint_budget_bytes: int | None = None,
                 spill_dir: str | None = None,
                 spill_budget_bytes: int | None = None,
                 evict: str = "lru",
                 prefetch_depth: int | None = None,
                 adaptive_block: bool = False,
                 prefetch_jitter=None,
                 clock=time.monotonic,
                 device=None):
        from repro_torch.api import TriangleCounter

        if policy not in ("fair", "fifo"):
            raise ValueError(f"policy must be 'fair' or 'fifo', got {policy!r}")
        if prefetch_depth is not None and (
                not isinstance(prefetch_depth, (int, np.integer))
                or isinstance(prefetch_depth, bool) or prefetch_depth < 1):
            raise ValueError(
                f"prefetch_depth must be a positive int (or None for the "
                f"synchronous path), got {prefetch_depth!r}")
        self.counter = counter or TriangleCounter(resources, device=device)
        self.resources = resources or self.counter.resources
        self.block_size = block_size
        self.policy = policy
        # prefetch_depth=K: every ACTIVE session gets a _PrefetchDriver with
        # a K-deep device-ready queue (None = synchronous). adaptive_block
        # turns on wall-clock-driven block resizing inside the driver;
        # prefetch_jitter is the concurrency-test hook — a callable the
        # producer thread invokes per command to perturb timing.
        self.prefetch_depth = int(prefetch_depth) if prefetch_depth else None
        self.adaptive_block = bool(adaptive_block)
        self.prefetch_jitter = prefetch_jitter
        self.queue_budget_bytes = (
            queue_budget_bytes if queue_budget_bytes is not None
            else self.resources.memory_bytes)
        self.store = CheckpointStore(
            checkpoint_budget_bytes if checkpoint_budget_bytes is not None
            else self.resources.memory_bytes,
            spill_dir=spill_dir, spill_budget_bytes=spill_budget_bytes,
            evict=evict)
        self._clock = clock
        self._on_card = self.counter.device.type == "cuda"
        self._recs: dict[int, _Session] = {}    # every non-closed session
        self._results: dict[int, object] = {}   # sid -> CountResult
        self.bytes_in_use = 0                   # device bytes pinned by actives
        self.queue_bytes = 0                    # host bytes buffered by waiters
        self._sched = {"preemptions": 0, "restores": 0,
                       "cancellations": 0, "expirations": 0}
        self._next_id = 0

    # -- lifecycle ---------------------------------------------------------
    def open(self, n_nodes: int, *, plan=None, block_size: int | None = None,
             window: int | None = None, priority: int = 0,
             deadline_s: float | None = None) -> int:
        """Admit (or queue) one more stream; returns its session id.

        ``window=E`` opens a sliding-window session (admission charges its
        E·n²/8 epoch-ring state). ``priority`` ranks the session for
        fair-share scheduling (higher wins; equal priorities are FIFO): under
        ``policy="fair"`` an open that would queue may instead PREEMPT
        strictly-lower-priority actives when checkpointing them frees enough
        device budget. ``deadline_s`` is an idle timeout. A stream whose
        state can NEVER fit — queue verdict even against an idle server — is
        rejected with ``ValueError`` instead of queueing forever.

        ``plan`` (a ``"stream"`` plan) runs the session under the caller's
        plan instead of the planner's: admission charges what it pins on
        the busiest device (``api.planner.plan_admission``), and its
        ``window_epochs`` is the window. This is how a session runs on every
        stage of a mesh that shares one card, a ring the planner never
        picks there. Traced as ``mux.open``, with the children
        ``mux.admission``, ``session.alloc`` and ``mux.replay``."""
        with tracing.span("mux.open") as sp:
            if (not isinstance(n_nodes, (int, np.integer))
                    or isinstance(n_nodes, bool) or n_nodes <= 0):
                raise ValueError(f"n_nodes must be a positive int, got {n_nodes!r}")
            if window is not None and (not isinstance(window, (int, np.integer))
                                       or isinstance(window, bool) or window <= 0):
                raise ValueError(
                    f"window must be a positive epoch count, got {window!r}")
            if not isinstance(priority, (int, np.integer)) or isinstance(priority, bool):
                raise ValueError(f"priority must be an int, got {priority!r}")
            if deadline_s is not None and not deadline_s > 0:
                raise ValueError(f"deadline_s must be > 0, got {deadline_s!r}")
            if plan is not None:
                if plan.method != "stream":
                    raise ValueError(f"open(plan=) needs a 'stream' plan, got {plan.method!r}")
                if window is not None and window != plan.window_epochs:
                    raise ValueError(
                        f"window={window} conflicts with the plan's window_epochs="
                        f"{plan.window_epochs} — pass the window through the plan")
                self.counter.check_stream_plan(plan)
                window = plan.window_epochs or None
            self._reap()
            # let live waiters claim any free budget (e.g. freed by an explicit
            # preempt) before the fairness gate treats them as blocking
            self._admit_pending()
            sid = self._next_id
            self._next_id += 1
            sp.sid = sid
            rec = _Session(
                sid=sid, n_nodes=int(n_nodes),
                block_size=block_size if block_size is not None else self.block_size,
                window=int(window) if window is not None else None,
                priority=int(priority), deadline_s=deadline_s,
                last_activity=self._clock(), asked=plan)
            # fairness gate: admit around the waiters only with strictly higher
            # priority than every one of them (FIFO within a priority level;
            # policy="fifo" never admits around any waiter). Parked sessions are
            # deliberately benched — they don't block anyone.
            blocking = any(
                r.state != "active" and not r.parked
                and (self.policy == "fifo" or r.priority >= rec.priority)
                for r in self._recs.values())
            if not blocking:
                with tracing.span("mux.admission", sid):
                    adm, victim_sids = self._admission(
                        rec.n_nodes, self.bytes_in_use, rec.window,
                        priority=rec.priority, preempt=self.policy == "fair",
                        block_size=rec.block_size, plan=plan)
                if adm.admitted:
                    from repro_torch.api.planner import BackpressureError

                    try:
                        if victim_sids:
                            self._preempt_many(victim_sids)
                    except BackpressureError:
                        pass  # store full: can't park the victims — queue instead
                    else:
                        self._recs[sid] = rec
                        self._admit(rec, adm)
                        return sid
            idle, _ = self._admission(rec.n_nodes, 0, rec.window,
                                      block_size=rec.block_size, idle=True, plan=plan)
            if not idle.admitted:
                raise ValueError(
                    f"stream of {rec.n_nodes} nodes can never be admitted on "
                    f"this server: {idle.reason}")
            rec.queued_ns = time.perf_counter_ns()
            self._recs[sid] = rec
            return sid

    def feed(self, sid: int, edges) -> None:
        """Feed one (B, 2) edge array to session ``sid``: ingested through
        the shared counter if active, buffered host-side if waiting (queued
        or preempted) — against the BOUNDED ``queue_budget_bytes``, raising
        ``BackpressureError`` past it. Edge arrays are validated at this
        front door either way (shape (B, 2), integer dtype, ids in
        ``[0, n_nodes)``). Traced as ``mux.feed``."""
        with tracing.span("mux.feed", sid):
            rec = self._rec(sid)
            if rec.state == "active":
                if rec.driver is not None:
                    from repro_torch.core import streaming

                    # validate HERE (front-door contract) so the producer thread
                    # only ever sees clean arrays and errors raise in the caller
                    rec.driver.submit(streaming.validate_edges(edges, rec.n_nodes))
                else:
                    rec.session.feed(edges)
                rec.served_blocks += 1
            else:
                from repro_torch.api.planner import BackpressureError
                from repro_torch.core import streaming

                arr = streaming.validate_edges(edges, rec.n_nodes)
                if self.queue_bytes + arr.nbytes > self.queue_budget_bytes:
                    raise BackpressureError(
                        f"waiting-session feed budget exhausted: {arr.nbytes} B "
                        f"over {self.queue_bytes}/{self.queue_budget_bytes} B "
                        f"already buffered across "
                        f"{self.n_queued + self.n_preempted} waiting session(s) "
                        f"— close an active session (or raise "
                        f"queue_budget_bytes)")
                rec.blocks.append(arr)
                rec.buffered_bytes += arr.nbytes
                self.queue_bytes += arr.nbytes
                rec.parked = False  # new activity: rejoin the readmission pool
            rec.last_activity = self._clock()

    def advance(self, sid: int) -> None:
        """Slide session ``sid``'s window one epoch (windowed sessions only).
        A WAITING windowed session records the boundary as a marker so its
        replay on admission (or restore) reproduces the exact epoch
        structure."""
        rec = self._rec(sid)
        if rec.state == "active":
            if rec.driver is not None:
                if not rec.window:
                    raise RuntimeError(
                        "advance() is for windowed sessions — open with "
                        "window=E")
                rec.driver.advance()
            else:
                rec.session.advance()
        else:
            if not rec.window:
                raise RuntimeError(
                    "advance() is for windowed sessions — open with window=E")
            rec.blocks.append(_ADVANCE)
            rec.parked = False  # new activity: rejoin the readmission pool
        rec.last_activity = self._clock()

    def preempt(self, sid: int) -> None:
        """Park active session ``sid`` host-side NOW: checkpoint its state
        into the bounded store, free its pinned device bytes, and mark it
        ``"preempted"``. Raises ``BackpressureError`` if the store cannot
        hold the snapshot (the session stays active), ``RuntimeError`` on a
        waiting/closed session, ``KeyError`` on an unknown sid."""
        if sid in self._results:
            raise RuntimeError(f"session {sid} already closed")
        if sid not in self._recs:
            raise KeyError(f"unknown session {sid}")
        rec = self._recs[sid]
        if rec.state != "active":
            raise RuntimeError(
                f"session {sid} is {rec.state} — only an active session has "
                f"device state to preempt")
        self._preempt_many([sid])
        # the freed bytes may admit another waiter right away; the parked
        # session itself stays benched until new activity (or close) revives it
        rec.parked = True
        self._admit_pending()

    def checkpoint(self, sid: int):
        """Snapshot ACTIVE session ``sid`` WITHOUT disturbing it and return
        the ``SessionCheckpoint`` (the session keeps ingesting). With async
        prefetch the driver is BARRIERED first and keeps running afterwards
        — the snapshot is bit-identical to the synchronous one."""
        rec = self._rec(sid)
        if rec.state != "active":
            raise RuntimeError(
                f"session {sid} is {rec.state} — only an active session has "
                f"device state to checkpoint")
        if rec.driver is not None:
            rec.driver.barrier()
        rec.last_activity = self._clock()
        return rec.session.checkpoint()

    def evict(self, sid: int):
        """Checkpoint ACTIVE session ``sid`` and FORGET it: the state leaves
        the device AND this scheduler — the sending half of checkpoint-based
        migration. Afterwards the sid is unknown here and the caller owns
        the returned checkpoint; freed budget admits waiters immediately."""
        rec = self._rec(sid)
        if rec.state != "active":
            raise RuntimeError(
                f"session {sid} is {rec.state} — only an active session has "
                f"device state to evict")
        self._quiesce(rec)
        ckpt = rec.session.checkpoint()
        rec.session = None  # free the state before the budget admits anyone
        self.bytes_in_use -= rec.state_bytes
        del self._recs[sid]
        self._admit_pending()
        return ckpt

    def adopt(self, ckpt, *, priority: int = 0) -> int:
        """Adopt a checkpoint taken by ANOTHER multiplexer (or the
        reference's): restore it as a fresh ACTIVE session of this scheduler
        and return its NEW sid — the receiving half of migration. A
        checkpoint that does not fit the free budget raises
        ``BackpressureError`` without touching the device."""
        from repro_torch.api.planner import BackpressureError

        needed = self._restored_state_bytes(ckpt)
        free = (self.resources.memory_bytes - self.bytes_in_use
                - self._card_reserve([(ckpt.n_nodes,
                                       self._run_plan(ckpt.plan, ckpt.block_size))]))
        if needed > free:
            raise BackpressureError(
                f"cannot adopt checkpoint of {needed} B restored state: "
                f"{free} B free of {self.resources.memory_bytes} B — close "
                f"or preempt an active session first")
        sid = self._next_id
        self._next_id += 1
        rec = _Session(
            sid=sid, n_nodes=ckpt.n_nodes, block_size=ckpt.block_size,
            window=ckpt.plan.window_epochs or None, priority=int(priority),
            deadline_s=None, last_activity=self._clock())
        self._recs[sid] = rec
        self._restore_from(rec, ckpt)
        return sid

    def close(self, sid: int):
        """Finalize ``sid`` and return its ``CountResult`` (idempotent).

        Closing frees the session's pinned state and admits waiters in
        fair-share order. A still-QUEUED session first retries admission; if
        it still cannot run, it is CANCELLED instead of raising. A PREEMPTED
        session with nothing fed since its checkpoint finalizes straight
        from the host snapshot (zero device cost, still exact); one with
        buffered feeds is restored first (preempting strictly-lower-priority
        actives if that is what it takes), and if the device cannot host
        that restore the close raises ``BackpressureError`` and the session
        stays parked. Traced as ``mux.close``."""
        with tracing.span("mux.close", sid):
            if sid in self._results:
                return self._results[sid]
            if sid not in self._recs:
                raise KeyError(f"unknown session {sid}")
            self._reap()
            if sid in self._results:  # the reap just expired it
                return self._results[sid]
            rec = self._recs[sid]
            if rec.state != "active":
                self._admit_pending()
            if rec.state == "preempted" and not rec.blocks:
                # nothing fed since the checkpoint: the count is already in the
                # host snapshot — finalize without touching the device
                result = self.store.take(sid).finalize_result()
                result.stats["priority"] = rec.priority
                result.stats["preempts"] = rec.n_preempts
                result.stats["restored"] = False
                del self._recs[sid]
                self._results[sid] = result
                self._admit_pending()
                return result
            if rec.state == "preempted":
                self._force_restore(rec)
            if rec.state == "queued":
                self._sched["cancellations"] += 1
                result = self._cancel(rec)
            else:
                self._quiesce(rec)
                result = rec.session.finalize()
                result.stats["restored"] = rec.session.restored
                # free the state before the budget admits anyone: on the card a
                # live reference would keep its memory while a waiter allocates
                rec.session = None
                self.bytes_in_use -= rec.state_bytes
                result.stats["priority"] = rec.priority
                result.stats["preempts"] = rec.n_preempts
                del self._recs[sid]
                self._results[sid] = result
            self._admit_pending()
            return result

    def kill(self, sid: int):
        """SIGKILL analogue: tear session ``sid`` down NOW, without draining.
        Its prefetch driver (if any) is killed with blocks still in flight
        (they are dropped, never ingested), its device bytes are freed, its
        host buffers and any parked checkpoint are discarded, and the cached
        result is a zero-count ``CountResult`` with ``stats["cancelled"]``.
        Every OTHER session stays fully consistent."""
        rec = self._rec(sid)
        if rec.driver is not None:
            rec.driver.kill()
            rec.driver = None
        if rec.state == "active":
            self.bytes_in_use -= rec.state_bytes
            rec.session = None
        elif rec.state == "preempted":
            self.store.drop(sid)
        self._sched["cancellations"] += 1
        result = self._cancel(rec)
        self._admit_pending()
        return result

    def status(self, sid: int) -> str:
        """``"active"`` (state pinned on device, feeds ingest), ``"queued"``
        (host-side buffer only, never admitted), ``"preempted"`` (state
        parked in the checkpoint store, feeds buffer), or ``"closed"``
        (result cached, state freed)."""
        if sid in self._results:
            return "closed"
        if sid not in self._recs:
            raise KeyError(f"unknown session {sid}")
        return self._recs[sid].state

    def state_bytes_of(self, sid: int) -> int:
        """The session's planner-charged state bytes (what admission pinned
        for an active session, or what readmission will re-pin for a parked
        one). 0 for a closed session."""
        if sid in self._results:
            return 0
        if sid not in self._recs:
            raise KeyError(f"unknown session {sid}")
        return self._recs[sid].state_bytes

    def next_sid(self, candidates=None) -> int | None:
        """The scheduler's pick of which ACTIVE session a driver should feed
        next (``None`` if none are active). ``policy="fair"``: highest
        priority first, then fewest blocks served, then arrival.
        ``policy="fifo"``: earliest arrival."""
        pool = [r for r in self._recs.values() if r.state == "active"
                and (candidates is None or r.sid in candidates)]
        if not pool:
            return None
        if self.policy == "fair":
            return min(pool,
                       key=lambda r: (-r.priority, r.served_blocks, r.sid)).sid
        return min(pool, key=lambda r: r.sid).sid

    def reap(self) -> None:
        """Apply deadline expiry now (also runs inside ``open``/``close``):
        an idle-past-deadline ACTIVE session is checkpointed off the device
        (cancelled outright if the store is full); an idle WAITING session is
        cancelled, its buffers and any parked checkpoint discarded."""
        self._reap()

    @property
    def sched_stats(self) -> dict:
        """Scheduler counters plus the checkpoint store's spill telemetry:
        ``spills``/``evictions`` counts and the live spill files' raw vs
        compressed (on-disk) bytes with their compression ratio."""
        s = self.store
        return {**self._sched, "spills": s.n_spills,
                "evictions": s.n_evictions,
                "spill_raw_bytes": s.spill_raw_bytes,
                "spill_disk_bytes": s.spill_bytes,
                "spill_compression": round(s.compression_ratio, 3)}

    @property
    def reserve_bytes(self) -> int:
        """Device bytes admission keeps free beside the active sessions'
        states: ``card_reserve_bytes`` of the active sessions on a ``cuda``
        counter, 0 elsewhere."""
        return self._card_reserve()

    @property
    def n_active(self) -> int:
        return sum(r.state == "active" for r in self._recs.values())

    @property
    def n_queued(self) -> int:
        return sum(r.state == "queued" for r in self._recs.values())

    @property
    def n_preempted(self) -> int:
        return sum(r.state == "preempted" for r in self._recs.values())

    # -- internals ---------------------------------------------------------
    def _attach_driver(self, rec: _Session) -> None:
        """Give a freshly-ACTIVE session its prefetch pipeline (no-op on the
        synchronous path). Always called AFTER the synchronous ``_replay``,
        so the producer thread starts from a quiescent buffer it then owns."""
        if self.prefetch_depth:
            rec.driver = _PrefetchDriver(
                rec.session, self.prefetch_depth,
                adaptive=self.adaptive_block, jitter=self.prefetch_jitter)

    def _quiesce(self, rec: _Session) -> None:
        """Drain and stop ``rec``'s prefetch driver (no-op without one): on
        return every in-flight block is ingested and the thread is joined,
        so the session state equals the synchronous driver's."""
        drv, rec.driver = rec.driver, None
        if drv is not None:
            drv.barrier()
            drv.shutdown()

    def _rec(self, sid: int) -> _Session:
        if sid in self._recs:
            return self._recs[sid]
        if sid in self._results:
            raise RuntimeError(f"session {sid} already closed")
        raise KeyError(f"unknown session {sid}")

    def _run_plan(self, plan, block_size):
        """``plan`` at the block size a session runs it with and this
        multiplexer's prefetch depth: what its card reserve is taken at."""
        return dataclasses.replace(
            plan, block_size=int(block_size or plan.block_size),
            prefetch_depth=self.prefetch_depth or 0)

    def _card_reserve(self, extra=(), *, actives: bool = True) -> int:
        """``card_reserve_bytes`` of the active sessions (unless
        ``actives=False``, an idle server) and the ``extra`` (n_nodes, plan)
        pairs on a ``cuda`` counter; 0 off the card, where admission is the
        reference's."""
        if not self._on_card:
            return 0
        from repro_torch.api.planner import card_reserve_bytes

        pairs = ([(r.n_nodes, r.plan) for r in self._recs.values()
                  if r.state == "active"] if actives else [])
        return card_reserve_bytes(pairs + list(extra), self.counter.mesh)

    def _restored_state_bytes(self, ckpt) -> int:
        """Device bytes a ``restore_stream(ckpt)`` will pin HERE, on its
        busiest device, without touching the device
        (``api.planner.plan_state_bytes`` under this counter's mesh)."""
        from repro_torch.api.planner import plan_state_bytes

        return plan_state_bytes(ckpt.n_nodes, ckpt.plan, self.counter.mesh)

    def _admission(self, n_nodes: int, bytes_in_use: int,
                   window: int | None, *, priority: int = 0,
                   preempt: bool = False, block_size: int | None = None,
                   idle: bool = False, plan=None):
        """Mesh-aware admission (``api.planner.mesh_admission``): the
        planner's per-stage accounting only holds where the counter's mesh
        hosts the stage axis one stage per device; otherwise the decision is
        re-taken at ring width 1. A caller's ``plan`` is admitted as it is
        (``api.planner.plan_admission``). With
        ``preempt`` the planner also sees the active sessions'
        ``(state_bytes, priority)`` and may return a ``"preempt"`` verdict.
        On the card every decision is taken against ``memory_bytes`` less
        the card's reserve — of the active sessions (none when ``idle``) and
        the candidate at the plan it is admitted with, retaken until that
        reserve holds. Returns ``(Admission, victim_sids)``."""
        from repro_torch.api.planner import mesh_admission, plan_admission

        active = ([r for r in self._recs.values() if r.state == "active"]
                  if preempt else [])
        actives = [(r.state_bytes, r.priority) for r in active] or None

        def decide(reserve):
            res = self.resources
            if reserve:
                res = dataclasses.replace(
                    res, memory_bytes=max(res.memory_bytes - reserve, 0))
            kw = dict(bytes_in_use=bytes_in_use, priority=priority, actives=actives,
                      prefetch_depth=self.prefetch_depth or 0)
            if plan is not None:
                return plan_admission(n_nodes, plan, res, self.counter.mesh, **kw)
            return mesh_admission(n_nodes, res, self.counter.mesh,
                                  window_epochs=window or 0, **kw)

        reserve = self._card_reserve(actives=not idle)
        adm = decide(reserve)
        while self._on_card and adm.admitted:
            # a smaller budget never plans a larger block, so the reserve
            # only grows until it holds
            need = self._card_reserve(
                [(n_nodes, self._run_plan(adm.plan, block_size))],
                actives=not idle)
            if need <= reserve:
                break
            reserve = need
            adm = decide(reserve)
        return adm, [active[i].sid for i in adm.victims]

    def _admit(self, rec: _Session, adm) -> None:
        if rec.queued_ns is not None:
            tracing.record("mux.queued", rec.queued_ns, time.perf_counter_ns(), rec.sid)
            rec.queued_ns = None
        if self.counter.device.type == "cuda":
            expandable_segments()
        # adm.plan carries window_epochs, so a windowed admission opens a
        # windowed session without re-stating the window here
        with tracing.span("session.alloc", rec.sid):
            rec.session = self.counter.open_stream(
                rec.n_nodes, plan=adm.plan, block_size=rec.block_size)
        rec.plan = self._run_plan(adm.plan, rec.session.block_size)
        rec.state = "active"
        rec.state_bytes = adm.state_bytes
        self.bytes_in_use += adm.state_bytes
        rec.last_activity = self._clock()
        self._replay(rec)
        self._attach_driver(rec)

    def _replay(self, rec: _Session) -> None:
        """Replay a waiter's host-buffered blocks (and epoch markers as
        ``advance()``) into its now-live session — bit-identical to a
        session that was never made to wait."""
        blocks, rec.blocks = rec.blocks, []
        self.queue_bytes -= rec.buffered_bytes
        rec.buffered_bytes = 0
        with tracing.span("mux.replay", rec.sid):
            for b in blocks:
                if isinstance(b, str):  # _ADVANCE epoch marker
                    rec.session.advance()
                else:
                    rec.session.feed(b)

    def _preempt_many(self, sids: list) -> None:
        """Checkpoint every session in ``sids`` into the store — all or
        nothing (``put_all``): checkpointing is non-destructive, so a
        ``BackpressureError`` from a full store leaves every victim still
        active and the device accounting untouched. Victims' prefetch
        drivers are QUIESCED first, and re-attached if the store refuses."""
        for v in sids:
            self._quiesce(self._recs[v])
        try:
            items = []
            for v in sids:
                with tracing.span("mux.preempt", v):
                    items.append((v, self._recs[v].session.checkpoint()))
            self.store.put_all(items)
        except BaseException:
            for v in sids:
                self._attach_driver(self._recs[v])
            raise
        for v in sids:
            r = self._recs[v]
            r.session = None
            r.state = "preempted"
            self.bytes_in_use -= r.state_bytes
            r.n_preempts += 1
            r.last_activity = self._clock()
            self._sched["preemptions"] += 1

    def _restore_from(self, rec: _Session, ckpt) -> None:
        if self.counter.device.type == "cuda":
            expandable_segments()
        with tracing.span("mux.restore", rec.sid):
            rec.session = self.counter.restore_stream(ckpt)
        rec.plan = self._run_plan(ckpt.plan, ckpt.block_size)
        rec.state = "active"
        rec.state_bytes = rec.session.state_bytes
        self.bytes_in_use += rec.state_bytes
        rec.last_activity = self._clock()
        self._sched["restores"] += 1
        self._replay(rec)
        self._attach_driver(rec)

    def _force_restore(self, rec: _Session) -> None:
        """Restore a preempted session for ``close``: its own checkpoint is
        taken OUT of the store first (freeing store room for any victims),
        then strictly-lower-priority actives are preempted if the device
        budget needs them. On failure the checkpoint goes back and the
        ``BackpressureError`` propagates — the close did not happen."""
        from repro_torch.api.planner import BackpressureError

        victims = self._victims_for(rec)
        if victims is None:
            raise BackpressureError(
                f"cannot restore preempted session {rec.sid} to close it: "
                f"{rec.state_bytes} B needed, "
                f"{self.resources.memory_bytes - self.bytes_in_use} B free "
                f"and no strictly-lower-priority active to preempt — close "
                f"an active session first")
        ckpt = self.store.take(rec.sid)
        try:
            if victims:
                self._preempt_many(victims)
        except BackpressureError:
            self.store.put(rec.sid, ckpt)  # same budget it fit a moment ago
            raise
        self._restore_from(rec, ckpt)

    def _victims_for(self, rec: _Session):
        """The minimal strictly-lower-priority victim set (lowest priority
        first, then largest state) whose preemption frees the device bytes
        ``rec``'s restore re-pins — ``[]`` if it already fits, ``None`` if no
        set can (or the policy forbids preemption)."""
        needed = rec.state_bytes
        remaining = (self.resources.memory_bytes - self.bytes_in_use
                     - self._card_reserve([(rec.n_nodes, rec.plan)]))
        if needed <= remaining:
            return []
        if self.policy != "fair":
            return None
        eligible = sorted(
            (r for r in self._recs.values()
             if r.state == "active" and r.priority < rec.priority),
            key=lambda r: (r.priority, -r.state_bytes, r.sid))
        freed, victims = 0, []
        for r in eligible:
            freed += r.state_bytes
            victims.append(r.sid)
            if needed <= remaining + freed:
                return victims
        return None

    def _admit_pending(self) -> None:
        """Admit waiters head-of-line in fair-share order — priority
        descending, FIFO within a level (plain FIFO under ``policy="fifo"``)
        — restoring preempted ones and replaying every waiter's buffered
        blocks. Stops at the first waiter that cannot run (no skipping).
        PARKED sessions sit the sweep out until activity revives them.
        Traced as ``mux.admit_pending``, which carries no sid: the spans
        under it carry those of the sessions they admit, restore or preempt."""
        with tracing.session(None), tracing.span("mux.admit_pending"):
            from repro_torch.api.planner import BackpressureError

            while True:
                waiters = [r for r in self._recs.values()
                           if r.state != "active" and not r.parked]
                if not waiters:
                    return
                if self.policy == "fair":
                    rec = min(waiters, key=lambda r: (-r.priority, r.sid))
                else:
                    rec = min(waiters, key=lambda r: r.sid)
                if rec.state == "preempted":
                    victims = self._victims_for(rec)
                    if victims is None:
                        return
                    ckpt = self.store.take(rec.sid)
                    try:
                        if victims:
                            self._preempt_many(victims)
                    except BackpressureError:
                        self.store.put(rec.sid, ckpt)
                        return
                    self._restore_from(rec, ckpt)
                else:
                    adm, victim_sids = self._admission(
                        rec.n_nodes, self.bytes_in_use, rec.window,
                        priority=rec.priority, preempt=self.policy == "fair",
                        block_size=rec.block_size, plan=rec.asked)
                    if not adm.admitted:
                        return
                    try:
                        if victim_sids:
                            self._preempt_many(victim_sids)
                    except BackpressureError:
                        return
                    self._admit(rec, adm)

    def _reap(self) -> None:
        """Expire sessions idle past their ``deadline_s``: active → parked
        checkpoint (cancel if the store will not take it); waiting →
        cancelled, buffers and parked checkpoint discarded. Parking resets
        the idle clock, so an abandoned active stream decays in two steps —
        device bytes freed first, host bytes one deadline later."""
        from repro_torch.api.planner import BackpressureError

        now = self._clock()
        freed = False
        for rec in list(self._recs.values()):
            if rec.deadline_s is None or now - rec.last_activity <= rec.deadline_s:
                continue
            if rec.state == "active":
                try:
                    self._preempt_many([rec.sid])
                    rec.parked = True
                    freed = True
                    continue
                except BackpressureError:
                    # cancel outright: the driver (re-attached by the failed
                    # preemption) dies WITH its in-flight blocks
                    if rec.driver is not None:
                        rec.driver.kill()
                        rec.driver = None
                    self.bytes_in_use -= rec.state_bytes
                    rec.session = None
            elif rec.state == "preempted":
                self.store.drop(rec.sid)
            self._sched["expirations"] += 1
            self._cancel(rec, expired=True)
            freed = True
        if freed:
            self._admit_pending()

    def _cancel(self, rec: _Session, *, expired: bool = False):
        """Drop a session that will never produce a real count: discard its
        host buffers and cache a zero-count ``CountResult`` (on the
        counter's device) flagged ``cancelled`` (and ``expired`` when a
        deadline reaped it)."""
        from repro_torch.api import CountResult

        self.queue_bytes -= rec.buffered_bytes
        result = CountResult(
            count=torch.zeros((), dtype=count_dtype(), device=self.counter.device),
            plan=None, wall_s=0.0,
            stats={"session": True, "cancelled": True, "expired": expired,
                   "priority": rec.priority, "preempts": rec.n_preempts,
                   "buffered_bytes_dropped": rec.buffered_bytes})
        del self._recs[rec.sid]
        self._results[rec.sid] = result
        return result
