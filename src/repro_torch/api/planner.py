"""The planner: ``plan(GraphStats, Resources) -> Plan``.

The paper's experimental finding is that the right Divide-and-Conquer shape
depends on measurable input properties: density decides dense-matmul vs
sorted-intersection, the replication factor Σ_v C(deg(v), 2) (Afrati–Ullman's
MapReduce communication cost, materialized as Round-I output by
``triangle_mapreduce``) decides whether MapReduce is even admissible, and
memory fit decides whether the graph can be held at all or must be consumed
as a stream. This module turns those properties into an inspectable,
serializable :class:`Plan` instead of a hand-picked ``method=`` string.

Cost units are relative work (operand elements touched, matrix-unit
discounted for matmuls); they only need to ORDER the methods correctly per
regime, not predict wall-clock. The constants are the reference's, kept as
they are until the port has measured rows of its own, so that both packages
plan alike. Memory predictions are bytes of live operands and are compared
against ``Resources.memory_bytes``.

Session admission (:func:`admit_session`) is the serving tier's memory
accounting, as in the reference; on the card the multiplexer also charges
one ingest's device scratch (:func:`card_reserve_bytes`). Multi-worker
placement (:func:`place_session` over one :class:`WorkerLoad` a worker)
is the cluster router's: the reference's least-loaded-by-bytes rule, with each
``cuda`` worker's verdict taken under the reserve its multiplexer charges
(:func:`worker_admission`).
"""
from __future__ import annotations

import dataclasses
import json

# Every method the planner can emit; executed by api.counter.TriangleCounter.
METHODS = ("dense", "ring", "sparse", "bitset_ring", "mapreduce", "stream")


class BackpressureError(RuntimeError):
    """A bounded host-side budget would be exceeded — graceful degradation
    instead of host OOM.

    Raised by the serving tier when feeding a queued/preempted session would
    overflow the queue buffer budget, or when checkpointing a session would
    overflow both the host checkpoint budget and the disk spill budget. The
    caller should retry after closing/draining sessions (or raise its own
    budgets); the server's host memory never grows past the configured
    bounds."""


# MapReduce is inadmissible once Round-I output exceeds this multiple of the
# input (the paper's dense-graph blowup: RF / m grows with density·n).
MR_RF_FACTOR = 8
# Relative per-element throughput discount for matrix-unit matmul vs vector
# ops (the reference's TPU constant, kept so both packages plan alike).
_MXU_DISCOUNT = 1.0 / 64.0
# Gather/popcount paths pay per-row DMA + address math on top of the word
# count — without this the bitset ring would beat the MXU on dense graphs,
# the opposite of what the hardware does.
_GATHER_PENALTY = 4.0
# The blocked streaming ingest runs three gather+popcount families per edge
# (pre-block closures + the two intra-block correction terms), so a resident
# graph forced through the stream path still costs ~3x the bitset ring.
_STREAM_PENALTY = 3.0
# Streaming block sizing: never pad tiny streams past the floor, never run
# a block larger than the cap, and keep the block working set within this
# fraction of the memory budget.
_STREAM_BLOCK_MIN = 4096
_STREAM_BLOCK_MAX = 1 << 20
_STREAM_BLOCK_MEM_FRACTION = 8
# Hybrid (degree-aware) state sizing: tail buffers hold this many neighbor
# slots per vertex (clamped around 8x the average degree when stats are
# informative), hub rows start at this floor and grow to the memory budget.
# Hybrid blocks are much smaller than bitset blocks because the block-local
# phase-2 working set is O(B^2) int32, not O(B·W).
_HYBRID_TAIL_MIN = 16
_HYBRID_TAIL_MAX = 1024
_HYBRID_TAIL_DEFAULT = 64
_HYBRID_HUB_MIN = 64
_HYBRID_BLOCK_MIN = 128
_HYBRID_BLOCK_MAX = 8192


def _pow2_at_least(x: int) -> int:
    """Smallest power of two >= max(x, 1)."""
    return 1 << max(int(x) - 1, 0).bit_length()


@dataclasses.dataclass(frozen=True)
class GraphStats:
    """The measurable input properties the planner decides on.

    Constructed from a materialized graph via :meth:`from_graph`, or by hand
    for graphs that only ever exist as a stream (``edges_in_memory=False``).
    """

    n_nodes: int
    n_edges: int
    replication_factor: int  # Σ_v C(deg(v), 2) — Afrati–Ullman comm. cost
    max_degree: int
    max_fwd_degree: int  # max forward degree under degree order (sparse row width)
    edges_in_memory: bool = True

    @property
    def density(self) -> float:
        n = self.n_nodes
        return 0.0 if n < 2 else self.n_edges / (n * (n - 1) / 2)

    @classmethod
    def from_graph(cls, g) -> "GraphStats":
        from repro_torch.core.partition import forward_degrees
        from repro_torch.core.triangle_mapreduce import mapreduce_replication_factor
        from repro_torch.graphs.formats import degree_order

        deg = g.degrees()
        rf = mapreduce_replication_factor(g)
        if g.n_edges:
            md = int(forward_degrees(g, degree_order(g)).max())
            dmax = int(deg.max())
        else:
            md = dmax = 0
        return cls(
            n_nodes=g.n_nodes,
            n_edges=g.n_edges,
            replication_factor=rf,
            max_degree=dmax,
            max_fwd_degree=md,
        )


@dataclasses.dataclass(frozen=True)
class Resources:
    """What the hardware offers: memory budget, ring width, kernel backend."""

    memory_bytes: int = 4 << 30
    n_devices: int = 1
    backend: str = "cpu"  # "cuda" turns on the CUDA kernels
    max_stages: int | None = None  # defaults to n_devices

    @classmethod
    def detect(cls, device=None) -> "Resources":
        """The resources of ``device`` (default ``cuda``): on a card, backend
        ``"cuda"``, the visible device count, and the card's total memory as
        the budget, since the operands live on the card. ``device="cpu"``
        reads the host's physical memory. Raises when no card is present
        and the CPU was not asked for."""
        import torch

        from repro_torch.utils import resolve_device

        dev = resolve_device(device)
        if dev.type == "cuda":
            props = torch.cuda.get_device_properties(dev)
            return cls(memory_bytes=int(props.total_memory),
                       n_devices=torch.cuda.device_count(), backend="cuda")
        try:
            import os

            mem = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        except (ValueError, OSError, AttributeError):
            mem = 4 << 30
        return cls(memory_bytes=int(mem), n_devices=1, backend=dev.type)


# Plan fields that inform ADMISSION/LOGGING only and are excluded from
# cache_key() on purpose: two plans differing only in these must share one
# cache entry. repro_lint R6 enforces that every Plan field is either
# in cache_key() or listed here, and R1/R6 reject reads of these fields
# from cache keys and executed paths.
ADMISSION_ONLY = frozenset({"predicted_bytes", "predicted_cost", "reason",
                            "prefetch_depth"})


@dataclasses.dataclass(frozen=True)
class Plan:
    """An inspectable, serializable execution plan.

    ``predicted_bytes`` / ``predicted_cost`` are the planner's estimates for
    the chosen method; ``reason`` records why it won so benchmarks and the
    serve loop can log the decision. Static execution knobs (batch sizes,
    kernel switch) live here so ``(plan.cache_key(), shape bucket)`` keys the
    counter's cache. The fields are the reference's, so a plan round-trips
    between the packages through ``to_dict``/``from_dict``.
    """

    method: str
    n_stages: int = 1
    use_kernel: bool = False
    interpret: bool = True
    balance: bool = True
    edge_batch: int = 4096  # sparse intersection batch
    node_batch: int = 256  # mapreduce reducer batch
    block_size: int = 65536  # streaming ingest block
    window_epochs: int = 0  # stream plans: sliding window of E epochs (0 = unbounded)
    # Degree-aware hybrid stream state (state_layout="hybrid"): bitset rows
    # for hub_slots high-degree vertices, tail_capacity-slot sorted buffers
    # for the rest, promotion at streamed degree >= hub_threshold. All four
    # fix the state's shapes or its promotion rule, so they live in
    # cache_key(), not ADMISSION_ONLY.
    state_layout: str = "bitset"
    hub_slots: int = 0
    tail_capacity: int = 0
    hub_threshold: int = 0
    # Async prefetch pipeline depth the session was ADMITTED with (0 = the
    # synchronous path). Admission-only on purpose: the in-flight blocks it
    # budgets are transient edge arrays, not state, and the ingest is
    # identical at every depth — two plans differing only here must share
    # one cache entry, so it stays out of cache_key() (R6).
    prefetch_depth: int = 0
    predicted_bytes: int = 0
    predicted_cost: float = 0.0
    reason: str = ""

    def cache_key(self) -> tuple:
        """The static part of the counter's cache key (shape bucket is
        added by the counter)."""
        return (self.method, self.n_stages, self.use_kernel, self.interpret,
                self.balance, self.edge_batch, self.node_batch, self.block_size,
                self.window_epochs, self.state_layout, self.hub_slots,
                self.tail_capacity, self.hub_threshold)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Plan":
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, s: str) -> "Plan":
        return cls.from_dict(json.loads(s))


def _choose_n_stages(stats: GraphStats, res: Resources) -> int:
    """``partition.choose_n_stages`` on stats: never more stages than
    devices, never fewer than 8 rows per stage."""
    from repro_torch.core.partition import choose_n_stages_for

    return choose_n_stages_for(stats.n_nodes, res.max_stages or res.n_devices)


def _predict(stats: GraphStats, res: Resources, method: str, n_stages: int) -> tuple[int, float]:
    """(bytes, cost) of running ``method`` on ``stats``."""
    n = max(stats.n_nodes, 1)
    m = max(stats.n_edges, 1)
    md = max(stats.max_fwd_degree, 1)
    dmax = max(stats.max_degree, 1)
    w = -(-n // 32)  # bitset words per row
    if method == "dense":
        # f32 U + f32 product + int32 mask, all (n, n)
        return 12 * n * n, float(n) ** 3 * _MXU_DISCOUNT
    if method == "ring":
        # uint8 blocks stream (1 B/entry) + resident block + wide partials
        return 3 * n * n, float(n) ** 3 * _MXU_DISCOUNT / max(1, min(n_stages, res.n_devices))
    if method == "sparse":
        return 4 * n * md + 8 * m, float(m) * md * _GATHER_PENALTY
    if method == "bitset_ring":
        # masks total n_pad²/8 + int32 edge stream
        return n * w * 4 + 8 * m, float(m) * w * _GATHER_PENALTY
    if method == "mapreduce":
        # padded symmetric adjacency + Round-I pair enumeration work
        return 8 * n * dmax + 8 * m, float(n) * dmax * dmax + float(stats.replication_factor)
    if method == "stream":
        # adjacency-so-far bitset, independent of stream length
        return n * w * 4, float(m) * w * _GATHER_PENALTY * _STREAM_PENALTY
    raise ValueError(f"unknown method {method!r}")


def stream_sizing(stats: GraphStats, res: Resources, *,
                  window_epochs: int = 0) -> tuple[int, int, int]:
    """(n_stages, block_size, shard_bytes) for a stream plan.

    n_stages: smallest ring width whose per-stage column shard of the
    adjacency bitset (n · ceil(W/S) · 4 ≈ n²/8/S bytes — ×E for a sliding
    window of ``window_epochs`` epoch bitsets) fits the memory budget,
    capped at the ring width (``max_stages`` or ``n_devices``).
    block_size: largest power of two in [4k, 1M] whose ingest working set
    (~8 gathered word-rows per edge; the windowed sweep gathers from E
    age-cumulative tables, so it scales ×E too) stays within 1/8 of the
    budget — big blocks amortize dispatch, but must not evict the state
    shard. ``shard_bytes`` is the PER-STAGE pinned state — the number
    :func:`admit_session` charges."""
    if window_epochs < 0:
        raise ValueError(f"window_epochs must be >= 0, got {window_epochs}")
    n = max(stats.n_nodes, 1)
    w = -(-n // 32)
    ef = max(window_epochs, 1)  # epoch bitsets pinned per stage
    max_stages = max(1, res.max_stages or res.n_devices)
    n_stages = 1
    while n_stages < max_stages and ef * 4 * n * (-(-w // n_stages)) > res.memory_bytes:
        n_stages += 1
    shard_bytes = ef * 4 * n * (-(-w // n_stages))
    per_edge_bytes = ef * 8 * 4 * (-(-w // n_stages)) + 8
    budget = max(res.memory_bytes // _STREAM_BLOCK_MEM_FRACTION, 1 << 20)
    block_size = _STREAM_BLOCK_MIN
    while block_size < _STREAM_BLOCK_MAX and 2 * block_size * per_edge_bytes <= budget:
        block_size *= 2
    return n_stages, block_size, shard_bytes


@dataclasses.dataclass(frozen=True)
class HybridSizing:
    """The hybrid regime's sizing verdict: state array shapes plus the bytes
    :func:`admit_session` charges for them (``state_bytes`` is EXACTLY
    ``streaming.hybrid_state_nbytes`` — the planner predicts the same number
    the session allocates, pinned by tests)."""

    hub_slots: int
    tail_capacity: int
    hub_threshold: int
    state_bytes: int
    block_size: int


def hybrid_sizing(stats: GraphStats, res: Resources) -> HybridSizing | None:
    """Size the degree-aware hybrid state for ``stats``, or ``None`` when a
    plain bitset is at least as small (small n — the hybrid's per-vertex
    fixed buffers would cost MORE than n²/8).

    With informative stats (``n_edges > 0``) the tail capacity is ~8x the
    average degree (power-law tails sit far below the mean, hubs far above —
    the promotion threshold catches the latter) and hub slots cover ~4x the
    vertices a uniform spread would need at that capacity. With stream-only
    stats (``n_edges == 0``) the tail defaults to ``_HYBRID_TAIL_DEFAULT``
    neighbors and hub slots grow from ``_HYBRID_HUB_MIN`` toward a quarter
    of the memory budget — admission cannot see degrees, so it buys as much
    promotion headroom as the budget allows. The block size keeps the
    block-local phase-2 working set (~16·B² bytes of packed int32 plus
    gathered rows) within a quarter of the budget."""
    n = max(stats.n_nodes, 1)
    w = -(-n // 32)
    n_cap = _pow2_at_least(n)
    budget = max(res.memory_bytes // 4, 1)
    if stats.n_edges > 0:
        avg = max(1, (2 * stats.n_edges) // n)
        cap = min(max(_pow2_at_least(8 * avg), _HYBRID_TAIL_MIN), _HYBRID_TAIL_MAX)
        hubs = min(max(_pow2_at_least(4 * stats.n_edges // cap + 1),
                       _HYBRID_HUB_MIN), n_cap)
    else:
        cap = _HYBRID_TAIL_DEFAULT
        hubs = _HYBRID_HUB_MIN
        while hubs * 2 <= n_cap and (hubs * 2) * w * 4 * 2 <= budget:
            hubs *= 2
    from repro_torch.core.streaming import hybrid_state_nbytes

    nbytes = hybrid_state_nbytes(n, hubs, cap)
    if nbytes >= 4 * n * w:  # dense bitset is no bigger: hybrid buys nothing
        return None
    block_budget = max(res.memory_bytes // 4, 1 << 20)
    block = _HYBRID_BLOCK_MIN
    while (block < _HYBRID_BLOCK_MAX
           and 2 * (32 * block * w + 16 * block * block) <= block_budget):
        block *= 2
    return HybridSizing(hub_slots=hubs, tail_capacity=cap, hub_threshold=cap,
                        state_bytes=nbytes, block_size=block)


def backend_exec_flags(res: Resources) -> dict:
    """The backend decision every executable plan carries: the CUDA kernels
    on a ``"cuda"`` backend, as the reference turns its Pallas kernels on
    for ``"tpu"``. In the port the operands' device picks the code that
    runs (a CUDA tensor always launches the kernel, a CPU tensor always runs
    the plain version); these flags keep the plan identical to the
    reference's and in its cache key, and the counter refuses a plan whose
    flags contradict its device. One definition so the planner and the
    counter's batch plan cannot drift apart."""
    return {"use_kernel": res.backend == "cuda",
            "interpret": res.backend != "cuda"}


def plan(stats: GraphStats, resources: Resources | None = None, *,
         allow: set[str] | None = None, window_epochs: int = 0) -> Plan:
    """Choose the counting method for ``stats`` under ``resources``.

    ``allow`` restricts the candidate set (e.g. ``{"mapreduce"}`` to force the
    baseline for a comparison run); default is every method, with ``stream``
    reserved for graphs that are not memory-resident. The winner is the
    memory-feasible candidate with the lowest predicted cost; if nothing fits,
    the smallest-footprint candidate is returned with a warning reason.

    ``window_epochs > 0`` asks for SLIDING-WINDOW streaming (only valid for
    non-resident stats): the plan's state is a ring of E epoch bitsets —
    E·n²/8 bytes, /S per stage — so sizing and admission charge E× the
    unbounded stream state, and the two-phase ingest runs one closure sweep
    per epoch age (cost ×E).

    This is the LAST step of every counter entry point's plan resolution
    (explicit ``plan=`` argument, else the counter's fixed plan, else this
    function), and the returned ``Plan`` is the counter's cache identity:
    two calls whose plans share ``cache_key()`` and shape bucket share one
    cache entry.
    """
    res = resources or Resources()
    allowed = set(allow) if allow is not None else set(METHODS)
    unknown = allowed - set(METHODS)
    if unknown:
        raise ValueError(f"unknown methods {sorted(unknown)}; valid: {METHODS}")

    if not stats.edges_in_memory:
        # The paper's "dynamically generated / does not fit" regime: the only
        # executable shape is the streaming fold over edge blocks.
        if allow is not None and "stream" not in allowed:
            raise ValueError("graph is not memory-resident; only 'stream' can run")
        if window_epochs < 0:
            raise ValueError(f"window_epochs must be >= 0, got {window_epochs}")
        ef = max(window_epochs, 1)
        nbytes, cost = _predict(stats, res, "stream", 1)
        nbytes, cost = ef * nbytes, ef * cost  # E epoch bitsets, E sweeps/block
        n_stages, block_size, shard_bytes = stream_sizing(
            stats, res, window_epochs=window_epochs)
        fits = shard_bytes <= res.memory_bytes
        # Degree-aware hybrid regime (unbounded streams only — the windowed
        # epoch ring and the mesh stage axis stay bitset): picked when the
        # dense/sharded bitset does NOT fit, or when informative stats say
        # the hybrid state is outright smaller than the best bitset shard.
        hyb = None if window_epochs else hybrid_sizing(stats, res)
        if hyb is not None and (not fits or (stats.n_edges > 0
                                             and hyb.state_bytes < shard_bytes)):
            hyb_fits = hyb.state_bytes <= res.memory_bytes
            return Plan(
                method="stream", n_stages=1, block_size=hyb.block_size,
                state_layout="hybrid", hub_slots=hyb.hub_slots,
                tail_capacity=hyb.tail_capacity, hub_threshold=hyb.hub_threshold,
                predicted_bytes=hyb.state_bytes, predicted_cost=cost,
                **backend_exec_flags(res),
                reason=(f"edges not memory-resident -> degree-aware hybrid "
                        f"streaming state ({hyb.hub_slots} hub bitset rows + "
                        f"{hyb.tail_capacity}-slot tail buffers, "
                        f"{hyb.state_bytes} B vs {shard_bytes} B bitset shard)"
                        + ("" if hyb_fits else
                           " (WARNING: even the hybrid state exceeds the "
                           "memory budget)")),
            )
        shape = (f"ring-sharded ({n_stages} stages, ~{shard_bytes >> 20} MB/stage) "
                 if n_stages > 1 else "")
        window = (f"windowed ({window_epochs}-epoch ring) " if window_epochs else "")
        return Plan(
            method="stream", n_stages=n_stages, block_size=block_size,
            window_epochs=window_epochs,
            predicted_bytes=nbytes, predicted_cost=cost,
            **backend_exec_flags(res),
            reason=f"edges not memory-resident -> {window}{shape}streaming bitset fold"
                   + ("" if fits else
                      " (WARNING: bitset state shard exceeds memory budget even "
                      f"at the full ring width {n_stages})"),
        )
    if window_epochs:
        raise ValueError(
            "window_epochs is a streaming knob: sliding windows only apply to "
            "non-memory-resident stats (edges_in_memory=False)")
    if allow is None:
        allowed.discard("stream")  # stream is for non-resident inputs only

    n_stages = _choose_n_stages(stats, res)
    rf_blowup = stats.replication_factor > MR_RF_FACTOR * max(stats.n_edges, 1)
    notes = []
    if rf_blowup and "mapreduce" in allowed and len(allowed) > 1:
        # Afrati–Ullman: Round-I output RF >> input — the paper's dense-graph
        # MapReduce blowup. Never auto-pick it; explicit allow={'mapreduce'}
        # still runs (comparison baselines need the losing side too).
        allowed.discard("mapreduce")
        notes.append(f"mapreduce dropped: RF={stats.replication_factor} "
                     f"> {MR_RF_FACTOR}x edges")

    candidates = []
    for method in METHODS:  # METHODS order is the tie-break preference
        if method not in allowed:
            continue
        stages = n_stages if method in ("ring", "bitset_ring") else 1
        nbytes, cost = _predict(stats, res, method, stages)
        candidates.append((method, stages, nbytes, cost))
    if not candidates:
        raise ValueError("no candidate methods allowed")

    fitting = [c for c in candidates if c[2] <= res.memory_bytes]
    if fitting:
        method, stages, nbytes, cost = min(fitting, key=lambda c: c[3])
        reason = (f"min predicted cost among {len(fitting)} memory-fitting "
                  f"candidate(s)")
    else:
        method, stages, nbytes, cost = min(candidates, key=lambda c: c[2])
        reason = "WARNING: nothing fits the memory budget; smallest footprint"
    if notes:
        reason += "; " + "; ".join(notes)
    if rf_blowup and method == "mapreduce":
        reason += (f"; WARNING: RF={stats.replication_factor} blowup — "
                   f"forced baseline")
    return Plan(
        method=method, n_stages=stages, **backend_exec_flags(res),
        predicted_bytes=int(nbytes), predicted_cost=float(cost), reason=reason,
    )


def plan_for_graph(g, resources: Resources | None = None, *,
                   allow: set[str] | None = None) -> Plan:
    """Convenience: measure ``g`` then :func:`plan`."""
    return plan(GraphStats.from_graph(g), resources, allow=allow)


# --------------------------------------------------------------------------
# Session admission — the serving story's memory accounting
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Admission:
    """The planner's verdict on opening ONE MORE concurrent stream session.

    ``action`` is ``"admit-dense"`` (plan has ``n_stages == 1``: the session's
    full n²/8 bitset fits the remaining budget), ``"admit-sharded"``
    (``n_stages > 1``: only a n²/8/S column shard per stage fits),
    ``"admit-hybrid"`` (``plan.state_layout == "hybrid"``: not even the
    max-ring-width bitset shard fits, but the degree-aware hybrid state —
    hub bitset rows + fixed-capacity tail buffers, linear in n — does; only
    for unbounded streams, the windowed epoch ring stays bitset),
    ``"preempt"`` (it fits only if the active sessions named by ``victims``
    are first checkpointed off the device — the fair-share verdict: every
    victim has STRICTLY lower priority than the request), or ``"queue"``
    (``plan`` is None: even the max-ring-width shard exceeds what is left
    and no preemption can free it — the request must wait for an active
    session to close instead of running the device out of memory).
    ``state_bytes`` is the per-stage bytes the session will pin while open
    — what the multiplexer adds to its in-use accounting on admit. Windowed
    sessions (``plan.window_epochs = E > 0``) pin E epoch bitsets, so every
    figure above is ×E: E·n²/8 dense, E·n²/8/S per stage.

    ``victims`` are indices into the ``actives`` sequence the caller passed
    to :func:`admit_session` — the minimal greedy set (lowest priority
    first, then largest state) whose checkpointed bytes, added to the
    remaining budget, fit the request. Empty for every other action.
    """

    action: str
    plan: Plan | None
    state_bytes: int
    reason: str
    victims: tuple = ()

    @property
    def admitted(self) -> bool:
        return self.action != "queue"


def admit_session(n_nodes: int, resources: Resources | None = None, *,
                  bytes_in_use: int = 0, window_epochs: int = 0,
                  priority: int = 0, actives=None,
                  prefetch_depth: int = 0) -> Admission:
    """Decide whether one more concurrent stream of ``n_nodes`` nodes fits.

    A stream session pins its adjacency-so-far bitset for its whole lifetime
    — n²/8 bytes dense, n²/8/S per stage when ring-sharded, and ×E for a
    sliding window of ``window_epochs`` epoch bitsets (E·n²/8, E·n²/8/S) —
    while edge blocks are transient. So admission charges
    ``Resources.memory_bytes`` only for state: ``bytes_in_use`` (the sum of
    ``state_bytes`` over currently active sessions) is subtracted and
    :func:`stream_sizing` picks the smallest ring width whose shard fits the
    REMAINDER. If even the full ring width does not fit, the verdict is
    ``"queue"``. The per-stage discount is the planner's mesh model; the
    multiplexer takes it only where the counter's mesh hosts the ring one
    stage per device (:func:`mesh_admission`). The verdicts are the
    reference's, number for number; the card's ingest scratch is charged by
    the multiplexer, not here (:func:`card_reserve_bytes`).

    FAIR-SHARE PREEMPTION: ``actives`` is the scheduler's view of the
    currently active sessions as ``(state_bytes, priority)`` pairs. When the
    request does not fit the remainder but checkpointing active sessions of
    STRICTLY lower ``priority`` would free enough device state, the verdict
    is ``"preempt"`` with ``victims`` naming the minimal greedy set (lowest
    priority first, then largest state). Equal-priority actives are never
    preempted; with ``actives=None`` (or no eligible victims) the verdict
    degrades to plain admit/queue.

    ``prefetch_depth=K`` charges the async prefetch pipeline's transient
    buffers up front — up to K device-ready padded (block, 2) int32 blocks
    plus as many again raw in the command queue — by SHRINKING the budget
    the state-sizing sweep sees. The returned plan records the depth
    (admission-only field, outside ``cache_key()``).
    """
    res = resources or Resources()
    remaining = max(res.memory_bytes - bytes_in_use, 0)
    stats = GraphStats(n_nodes=n_nodes, n_edges=0, replication_factor=0,
                       max_degree=0, max_fwd_degree=0, edges_in_memory=False)
    prefetch_bytes = 0
    if prefetch_depth:
        _, blk, _ = stream_sizing(
            stats, dataclasses.replace(res, memory_bytes=remaining),
            window_epochs=window_epochs)
        prefetch_bytes = 2 * int(prefetch_depth) * blk * 2 * 4
        remaining = max(remaining - prefetch_bytes, 0)
    sub = dataclasses.replace(res, memory_bytes=remaining)

    def _stamp(adm: Admission) -> Admission:
        """Record the admitted prefetch depth on the plan (admission-only
        field — the ingest is depth-independent)."""
        if prefetch_depth and adm.plan is not None:
            adm = dataclasses.replace(adm, plan=dataclasses.replace(
                adm.plan, prefetch_depth=int(prefetch_depth)))
        return adm
    n_stages, _, shard_bytes = stream_sizing(stats, sub,
                                             window_epochs=window_epochs)
    window = f"windowed ({window_epochs} epochs) " if window_epochs else ""
    if shard_bytes > remaining:
        # degree-aware hybrid fallback (unbounded streams only): when even
        # the max-ring-width bitset shard overflows the remainder, the
        # linear-in-n hybrid state may still fit. plan(stats, sub) picks
        # hybrid by the same rule, so plan and charge stay consistent.
        hyb = None if window_epochs else hybrid_sizing(stats, sub)
        if hyb is not None and hyb.state_bytes <= remaining:
            return _stamp(Admission(
                action="admit-hybrid",
                plan=plan(stats, sub, window_epochs=window_epochs),
                state_bytes=hyb.state_bytes,
                reason=(f"admit-hybrid: bitset shard needs {shard_bytes} B "
                        f"but the degree-aware hybrid state "
                        f"({hyb.hub_slots} hub rows + {hyb.tail_capacity}-slot "
                        f"tail buffers) fits {hyb.state_bytes} B into the "
                        f"{remaining} B remaining "
                        f"({bytes_in_use} B already pinned)")))
        # preemption sweep: grow the budget victim by victim (lowest
        # priority, then largest state) until the request's shard — bitset
        # first, hybrid as the same fallback — fits
        eligible = sorted(
            (i for i, (nbytes, prio) in enumerate(actives or ())
             if prio < priority),
            key=lambda i: (actives[i][1], -actives[i][0], i))
        freed, victims = 0, []
        for i in eligible:
            freed += actives[i][0]
            victims.append(i)
            sub_k = dataclasses.replace(res, memory_bytes=remaining + freed)
            n_stages, _, shard_bytes = stream_sizing(
                stats, sub_k, window_epochs=window_epochs)
            hyb_k = None if window_epochs else hybrid_sizing(stats, sub_k)
            fit_bytes = None
            if shard_bytes <= remaining + freed:
                fit_bytes = shard_bytes
            elif hyb_k is not None and hyb_k.state_bytes <= remaining + freed:
                fit_bytes = hyb_k.state_bytes
            if fit_bytes is not None:
                return _stamp(Admission(
                    action="preempt",
                    plan=plan(stats, sub_k, window_epochs=window_epochs),
                    state_bytes=fit_bytes, victims=tuple(victims),
                    reason=(f"preempt: {window}{fit_bytes} B/stage state "
                            f"fits only after checkpointing {len(victims)} "
                            f"lower-priority active(s) ({freed} B freed, "
                            f"priority {priority} over "
                            f"{[actives[i][1] for i in victims]})")))
        return Admission(
            action="queue", plan=None, state_bytes=shard_bytes,
            reason=(f"{window}state shard needs {shard_bytes} B but "
                    f"{remaining} B of {res.memory_bytes} B remain (even at "
                    f"ring width {n_stages}"
                    + (f", and the {hyb.state_bytes} B hybrid state does not "
                       f"fit either" if hyb is not None else "")
                    + (f"; preempting all {len(eligible)} lower-priority "
                       f"active(s) frees only {freed} B" if eligible else "")
                    + (f" ({prefetch_bytes} B reserved for the depth-"
                       f"{prefetch_depth} prefetch pipeline)"
                       if prefetch_bytes else "")
                    + ") — queue until an active session closes"))
    kind = "sharded" if n_stages > 1 else "dense"
    return _stamp(Admission(
        action=f"admit-{kind}",
        plan=plan(stats, sub, window_epochs=window_epochs),
        state_bytes=shard_bytes,
        reason=(f"admit-{kind}: {window}{shard_bytes} B/stage state fits the "
                f"{remaining} B remaining ({bytes_in_use} B already pinned"
                + (f"; {prefetch_bytes} B reserved for the depth-"
                   f"{prefetch_depth} prefetch pipeline)" if prefetch_bytes
                   else ")"))))


def _hosts(mesh, n_stages: int) -> bool:
    """Whether ``mesh`` hosts a ring of ``n_stages`` (> 1) stages."""
    return n_stages > 1 and mesh is not None and mesh.size == n_stages


def device_state_bytes(stage_bytes: int, n_stages: int, mesh=None) -> int:
    """The bytes a state of ``n_stages`` shards of ``stage_bytes`` each pins
    on its busiest device. Where ``mesh`` hosts the ring (``n_stages`` equal
    to its width, above 1) that is one shard for each stage the device
    hosts: ``stage_bytes`` on a mesh of distinct devices — the reference's
    per-stage charge — and the whole state when all stages share one card,
    since shards that share a device add up on it. Without such a mesh the
    stages are emulated on one device, which holds them all."""
    if _hosts(mesh, n_stages):
        return stage_bytes * mesh.stages_per_device()
    return stage_bytes * n_stages


def plan_state_bytes(n_nodes: int, plan: Plan, mesh=None) -> int:
    """Device bytes a stream of ``n_nodes`` nodes under ``plan`` pins on the
    busiest device of ``mesh``, without touching a device: the hybrid
    state's allocation, or the epoch ring's column shards through
    :func:`device_state_bytes` — ``StreamSession.state_bytes`` before the
    session exists."""
    if plan.state_layout == "hybrid":
        from repro_torch.core.streaming import hybrid_state_nbytes

        return hybrid_state_nbytes(n_nodes, plan.hub_slots, plan.tail_capacity)
    w = -(-n_nodes // 32)
    per_stage = max(plan.window_epochs, 1) * 4 * n_nodes * -(-w // max(plan.n_stages, 1))
    return device_state_bytes(per_stage, plan.n_stages, mesh)


def mesh_admission(n_nodes: int, resources: Resources | None = None, mesh=None,
                   **kw) -> Admission:
    """:func:`admit_session` (``kw`` are its keywords) as a multiplexer
    whose counter holds ``mesh`` takes it: the planner's n²/8/S-per-stage
    accounting holds only where the mesh hosts the plan's ring with one
    stage per device. Otherwise — no mesh, a mesh of another width, or
    stages that share a device and so add up on it
    (:func:`device_state_bytes`) — the decision is re-taken at ring width
    1, where the charge is the whole state. On a mesh of distinct devices
    this is the reference's rule, verdict for verdict; where the stages
    share a device the planner never picks the ring (it gives a session no
    memory there), and a session reaches it through an explicit plan
    (:func:`plan_admission`)."""
    res = resources or Resources()
    adm = admit_session(n_nodes, res, **kw)
    if (adm.admitted and adm.plan.n_stages > 1
            and device_state_bytes(adm.state_bytes, adm.plan.n_stages, mesh)
            != adm.state_bytes):
        adm = admit_session(n_nodes, dataclasses.replace(res, max_stages=1), **kw)
    return adm


def plan_admission(n_nodes: int, plan: Plan, resources: Resources | None = None,
                   mesh=None, *, bytes_in_use: int = 0, priority: int = 0,
                   actives=None, prefetch_depth: int = 0) -> Admission:
    """Admission of a stream that runs the caller's ``plan`` instead of the
    planner's. The charge is what the plan pins on the busiest device of
    ``mesh`` (:func:`plan_state_bytes`), taken against the remainder as
    :func:`admit_session` takes a planned state: admitted if it fits, else
    ``"preempt"`` if checkpointing strictly-lower-priority ``actives``
    (lowest priority first, then largest state) frees enough, else
    ``"queue"``; the prefetch pipeline's blocks shrink the remainder first.
    The reference's multiplexer plans every session itself; this is how a
    session reaches a ring the planner would not pick, such as the stages
    of a mesh that share one card."""
    res = resources or Resources()
    charge = plan_state_bytes(n_nodes, plan, mesh)
    prefetch_bytes = 2 * int(prefetch_depth) * plan.block_size * 2 * 4
    remaining = max(res.memory_bytes - bytes_in_use - prefetch_bytes, 0)
    if prefetch_depth:
        plan = dataclasses.replace(plan, prefetch_depth=int(prefetch_depth))
    kind = ("hybrid" if plan.state_layout == "hybrid"
            else "sharded" if plan.n_stages > 1 else "dense")
    if charge <= remaining:
        return Admission(
            action=f"admit-{kind}", plan=plan, state_bytes=charge,
            reason=(f"admit-{kind}: the caller's plan pins {charge} B, within the "
                    f"{remaining} B remaining ({bytes_in_use} B already pinned)"))
    eligible = sorted(
        (i for i, (_, prio) in enumerate(actives or ()) if prio < priority),
        key=lambda i: (actives[i][1], -actives[i][0], i))
    freed = 0
    for k, i in enumerate(eligible):
        freed += actives[i][0]
        if charge <= remaining + freed:
            return Admission(
                action="preempt", plan=plan, state_bytes=charge,
                victims=tuple(eligible[:k + 1]),
                reason=(f"preempt: the caller's plan pins {charge} B, which fits only "
                        f"after checkpointing {k + 1} lower-priority active(s) "
                        f"({freed} B freed)"))
    return Admission(
        action="queue", plan=None, state_bytes=charge,
        reason=(f"the caller's plan pins {charge} B but {remaining} B of "
                f"{res.memory_bytes} B remain"
                + (f"; preempting all {len(eligible)} lower-priority active(s) "
                   f"frees only {freed} B" if eligible else "")
                + " — queue until an active session closes"))


# --------------------------------------------------------------------------
# The card's reserve: one ingest's device scratch beside the pinned states
# --------------------------------------------------------------------------
# Per-row temporaries of one block's ingest on the card (endpoint keys, the
# dedup sort, gathered words, the delta's bit indices, phantom edges, the
# block's own copy): FNA.5's stream of 1,048,576-row blocks peaked 127 MB
# above its state (chip_smoke.py [stream] on an H100, PR 19), ~121 B a row;
# budgeted at about twice that.
_CARD_ROW_BYTES = 256
# What the card holds outside any session's tensors: the CUDA context, the
# loaded kernel modules (the port's, cuBLAS's) and the caching allocator's
# partly used segments (chip_smoke.py [serve streams] prints it).
_CARD_FIXED_BYTES = 2 << 30


def ingest_scratch_bytes(n_nodes: int, plan: Plan, mesh=None) -> int:
    """Device bytes one ingest of a block under ``plan`` allocates beside
    the session's state on its busiest device, at the plan's block size
    rounded up to a power of two (the adaptive sizer's ceiling): what
    :func:`stream_sizing` leaves out of a stream's ``predicted_bytes``.

    - bitset: the block's (n, ceil(W/S)) delta table (8.73 GB at NY) — one
      for each stage on the device where ``mesh`` hosts the ring, since
      those stages run at once on their own streams, while emulated stages
      take turns on one stream — and for a window every stage's E
      age-cumulative tables (E·n·S·ceil(W/S) words). Off the mesh the
      counter's ``core.streaming.DeltaPool`` holds that table between
      blocks instead of filling one a block; the charge is the same, since
      the multiplexer keeps the held table no larger than the largest
      charged here;
    - hybrid: the (2B, W) table of the endpoints' pre-block rows, the two
      block-local packed tables (2B, Wl), one slab of the packing and the
      (2B, C) gathers of tail buffers;
    - both: ``_CARD_ROW_BYTES`` of per-row temporaries."""
    n = max(int(n_nodes), 1)
    w = -(-n // 32)
    b = _pow2_at_least(plan.block_size)
    rows = _CARD_ROW_BYTES * b
    if plan.state_layout == "hybrid":
        from repro_torch.core.streaming import _ALOC_WORDS

        wl = -(-min(2 * b, n + 1) // 32)
        table = 4 * 2 * b * w
        local = 2 * 4 * 2 * b * wl
        slab = 4 * min(2 * b * 32 * wl, _ALOC_WORDS)
        tails = 128 * b * max(plan.tail_capacity, 1)
        return table + local + slab + tails + rows
    ws = -(-w // max(plan.n_stages, 1))
    # the stages a mesh hosts on one device run at once, each with its own
    # table; emulated stages take turns on one stream and reuse one
    delta = 4 * n * ws * (mesh.stages_per_device() if _hosts(mesh, plan.n_stages) else 1)
    cum = plan.window_epochs * plan.n_stages * 4 * n * ws
    return delta + cum + rows


def prefetch_inflight_bytes(plan: Plan) -> int:
    """Device bytes of the padded (B, 2) int32 blocks one session holds
    ahead of its ingest: the ``plan.prefetch_depth`` device-ready blocks of
    its async pipeline and the block being ingested (a feed of at most one
    block's rows; a larger feed's further blocks fall under the per-row
    scratch of :func:`ingest_scratch_bytes`)."""
    return (plan.prefetch_depth + 1) * _pow2_at_least(plan.block_size) * 2 * 4


def card_reserve_bytes(sessions, mesh=None) -> int:
    """The device bytes a stream multiplexer on the card keeps free beside
    the pinned states of ``sessions`` — (n_nodes, plan) pairs of the active
    sessions and the one being admitted, each plan at the block size it
    runs: the fixed share of the CUDA context and the allocator, the largest
    :func:`ingest_scratch_bytes` on the busiest device of the counter's
    ``mesh`` (ingests run one at a time, from one drive thread, so their
    scratch is reused, not summed; a mesh ingest's stages overlap only with
    each other), and every session's :func:`prefetch_inflight_bytes`. The
    reference admits by state bytes alone; charged only on the card, so CPU
    verdicts stay the reference's."""
    pairs = list(sessions)
    return (_CARD_FIXED_BYTES
            + max((ingest_scratch_bytes(n, p, mesh) for n, p in pairs), default=0)
            + sum(prefetch_inflight_bytes(p) for _, p in pairs))


# --------------------------------------------------------------------------
# Multi-worker placement — per-worker capacity accounting on the cluster tier
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class WorkerLoad:
    """One worker's capacity story, as the router sees it.

    ``resources`` is the worker's advertised budget (its ``Resources``:
    memory, ring width, backend); ``charged_bytes`` is the sum of the
    planner-predicted state bytes of every session the router has placed on
    it — the Afrati–Ullman accounting unit: placement is charged in BYTES of
    pinned bitset state, never in session counts. ``mesh_devices`` is the
    ring width whose per-stage n²/8/S discount the worker's mesh really
    gives (0 = none): a mesh of one stage per device advertises its width,
    and a mesh whose stages share a device advertises 0, since its shards
    add up there — exactly the multiplexer's re-take rule
    (:func:`mesh_admission`), so the router predicts the bytes the worker
    will charge.

    ``sessions`` holds the ``(n_nodes, plan)`` of the sessions the router
    placed on the worker, each plan at the block size it runs: on a
    ``cuda`` worker :func:`worker_admission` charges the card's reserve of
    these and the candidate (:func:`card_reserve_bytes`), as the worker's
    multiplexer does. ``block_size`` is the block size the worker will run
    the candidate at (None = the plan's). On a CPU worker neither is read,
    and every verdict is the reference's."""

    resources: Resources
    charged_bytes: int = 0
    mesh_devices: int = 0
    sessions: tuple = ()
    block_size: int | None = None


@dataclasses.dataclass(frozen=True)
class Placement:
    """The planner's verdict on placing one session across many workers.

    ``action`` is ``"place"`` (``worker`` indexes the chosen entry in the
    ``loads`` sequence and ``admission`` is that worker's verdict),
    ``"queue"`` (no worker fits RIGHT NOW but at least one could when idle —
    the caller should retry after sessions close), or ``"reject"`` (the
    session could NEVER fit any worker, even idle — the front door should
    refuse it outright instead of queueing forever)."""

    action: str
    worker: int | None
    admission: Admission | None
    state_bytes: int
    reason: str

    @property
    def placed(self) -> bool:
        return self.action == "place"


def worker_admission(n_nodes: int, load: WorkerLoad, *,
                     window_epochs: int = 0,
                     bytes_in_use: int | None = None) -> Admission:
    """:func:`admit_session` through one worker's mesh model: when the
    planner's ring width does not match ``load.mesh_devices``, the
    per-stage discount is unreal (the shards share a device), so the
    decision is RE-TAKEN at ring width 1 — the rule the worker's
    multiplexer applies (:func:`mesh_admission`), lifted here so the
    router's predicted bytes always equal what the worker will charge.

    On a ``cuda`` worker the decision is taken, as its multiplexer takes
    it, against ``memory_bytes`` less :func:`card_reserve_bytes` of
    ``load.sessions`` and the candidate at the plan it is admitted with
    (run at ``load.block_size``), retaken until that reserve holds. The
    reference knows no reserve; a router using its rule would place
    sessions the card's worker then queues. Like the reference, the model
    is a worker without a prefetch pipeline."""
    used = load.charged_bytes if bytes_in_use is None else bytes_in_use

    def decide(res: Resources) -> Admission:
        adm = admit_session(n_nodes, res, bytes_in_use=used,
                            window_epochs=window_epochs)
        if (adm.admitted and adm.plan.n_stages > 1
                and adm.plan.n_stages != load.mesh_devices):
            adm = admit_session(
                n_nodes, dataclasses.replace(res, max_stages=1),
                bytes_in_use=used, window_epochs=window_epochs)
        return adm

    res = load.resources
    if res.backend != "cuda":
        return decide(res)
    sessions = list(load.sessions)
    reserve = card_reserve_bytes(sessions)
    while True:
        adm = decide(dataclasses.replace(
            res, memory_bytes=max(res.memory_bytes - reserve, 0)))
        if not adm.admitted:
            return adm
        # a smaller budget never plans a larger block, so the reserve only
        # grows until it holds
        run = dataclasses.replace(
            adm.plan, block_size=int(load.block_size or adm.plan.block_size))
        need = card_reserve_bytes(sessions + [(n_nodes, run)])
        if need <= reserve:
            return adm
        reserve = need


def place_session(n_nodes: int, loads, *, window_epochs: int = 0) -> Placement:
    """Least-loaded-by-bytes placement of one more stream session.

    ``loads`` is the router's view of its live workers (a sequence of
    :class:`WorkerLoad`). Every worker gets the mesh-aware
    :func:`worker_admission` verdict at its current ``charged_bytes``; among
    the workers that ADMIT, the one with the fewest charged bytes wins (ties
    break to the lowest index — deterministic placement). When nobody admits
    the verdict degrades the same way :func:`admit_session` does: ``"queue"``
    if some worker could host the session idle (re-checked with no session
    placed on it), ``"reject"`` if none ever could — the cluster front
    door's never-fits rejection."""
    if not loads:
        return Placement(action="reject", worker=None, admission=None,
                         state_bytes=0, reason="no live workers")
    fitting = []
    for i, load in enumerate(loads):
        adm = worker_admission(n_nodes, load, window_epochs=window_epochs)
        if adm.admitted:
            fitting.append((i, load, adm))
    if fitting:
        i, load, adm = min(fitting, key=lambda t: (t[1].charged_bytes, t[0]))
        return Placement(
            action="place", worker=i, admission=adm,
            state_bytes=adm.state_bytes,
            reason=(f"least-loaded-by-bytes: worker {i} at "
                    f"{load.charged_bytes} B charged ({len(fitting)} of "
                    f"{len(loads)} worker(s) fit); {adm.reason}"))
    idle_fits = any(
        worker_admission(n_nodes, dataclasses.replace(
            load, charged_bytes=0, sessions=()),
            window_epochs=window_epochs).admitted
        for load in loads)
    window = f"windowed ({window_epochs} epochs) " if window_epochs else ""
    if idle_fits:
        return Placement(
            action="queue", worker=None, admission=None, state_bytes=0,
            reason=(f"{window}session of {n_nodes} nodes fits no worker at "
                    f"current load — retry after sessions close"))
    return Placement(
        action="reject", worker=None, admission=None, state_bytes=0,
        reason=(f"{window}session of {n_nodes} nodes can NEVER fit any of "
                f"the {len(loads)} worker(s), even idle"))
