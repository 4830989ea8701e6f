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

Session admission and multi-worker placement come with the port's serving
tier (ROADMAP.md, queue A).
"""
from __future__ import annotations

import dataclasses
import json

# Every method the planner can emit; executed by api.counter.TriangleCounter.
METHODS = ("dense", "ring", "sparse", "bitset_ring", "mapreduce", "stream")


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
    session admission charges."""
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
    session admission charges for them (``state_bytes`` is EXACTLY
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
