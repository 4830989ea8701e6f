"""Streaming triangle counting — the paper's "graph dynamically generated /
does not fit in memory" regime, as an incremental API, on one device or a
ring mesh.

A triangle is counted exactly once: when its LAST edge arrives. The state is
the adjacency-so-far bitset (n, W) of 32-bit words (n²/8 bytes, independent
of the stream length). Words travel as int32 with the bit pattern of the
reference's uint32 (``snapshot_state``/``restore_state`` view them as
uint32 at the host boundary); counts are int64.

Two ingest implementations share that contract:

- ``ingest_block`` — the production path: a TWO-PHASE blocked ingest. Phase 1
  closes every edge of the block against the PRE-BLOCK adjacency A
  (``pre``, the one-table bitset closure K3). Phase 2 adds the exact
  intra-block correction from the block's own delta-adjacency D:
  Σ_e pc(A[u]&D[v]) + pc(D[u]&A[v]) (``mixed``, two launches of the
  two-table closure K4) counts each (block, block, A) triangle twice and
  Σ_e pc(D[u]&D[v]) (``dd``, K3 on D) counts each all-in-block triangle
  three times, so the block adds ``pre + mixed//2 + dd//3`` (A and D are
  disjoint by dedup, so the terms never overlap).
- ``ingest_block_per_edge`` — the per-edge fold, RETAINED AS THE
  DIFFERENTIAL ORACLE: one edge at a time on the host, trivially correct.

The device decides what runs, as for every kernel of the port: a state on
the card launches K3 and K4 (no budget gates them — the reference's
VMEM/SMEM gate is a TPU limit), a state on the CPU runs their plain
versions, which gather rows a chunk at a time. Each ingest updates the
state tensors IN PLACE and returns the same dict: the block's live bits
are added straight into the adjacency (add equals OR, because dedup makes
them distinct and absent), so no whole-table OR runs per block. D itself
is a fresh zeroed (n, W) table per block — the K4 operand.

``init_sharded_state``/``ingest_block_sharded`` are the column-sharded
variant: stage s owns words [s·Ws, (s+1)·Ws) of every row, and every
popcount term is a sum over words, so each stage computes its shard's
partials and the totals are summed BEFORE the divisions. ``ingest_block_
sharded`` emulates the S shards on one device in a loop, which launches
K3/K4 per shard. On a ``launch.mesh.RingMesh`` (``make_mesh_ingest``) each
shard lives on its stage's device and is folded on its stage's stream, in
the phases of ``dynamic_pipeline.ShardedStateStream``: a mesh state holds
a LIST of S shards (``adj`` and ``epochs``) and its counters on stage 0's
device, and its host snapshot has the emulated (S, ...) layout, so a
checkpoint moves between mesh and emulated sessions both ways.

SLIDING WINDOWS (``init_windowed_state``/``ingest_block_windowed``/
``expire_epoch``) add deletions: the state is a ring of E epoch bitsets
whose OR is the LIVE adjacency. ``expire_epoch`` slides the window by
moving the ring head and clearing ONE slot. Exactness comes from
attribution: ``counts[r]`` holds the live triangles whose OLDEST edge sits
in slot r, so the window's count is ``counts.sum()``. Phase 1 sweeps the
block against the E age-cumulative OR tables and adjacent differences
attribute each closure to the age of its oldest wedge edge; the mixed term
is differenced the same way; ``dd`` is unchanged. A duplicate of a
still-live edge is ignored; an edge re-inserted after expiry is new.

The DEGREE-AWARE HYBRID state (``init_hybrid_state``/``ingest_block_hybrid``)
escapes the n²/8 wall for unbounded streams: full bitset rows only for
promoted hubs, fixed-capacity sorted neighbor buffers for the tail, linear
in n. Its block ingest keeps the same ``pre + mixed//2 + dd//3`` contract:
``pre`` closes each edge against its two full-width pre-block rows with the
per-edge closure K5, and ``mixed``/``dd`` run K4/K3 on block-local packed
tables. The reference drops out-of-range scatters (JAX's rule); here every
such write adds 0 at index 0 instead, since PyTorch raises.

Eager PyTorch compiles nothing, so the reference's trace telemetry becomes
a count of first uses: :func:`ingest_trace_count` counts the distinct
(ingest family, block shape, state shape, device) keys seen, so the
reference's "one trace per fixed block shape" pins carry over as "one key".
"""
from __future__ import annotations

import threading
from functools import lru_cache

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.kernels.bitset_count.ops import (
    bitset_edge_count,
    bitset_edge_count_per_edge,
    bitset_pair_count,
)
from repro_torch.utils import count_dtype, resolve_device

# bit b of a 32-bit word as int32 (bit 31 is -2**31): a table, so no int32
# shift ever overflows
_BITS = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32)).view(np.int32)


def _zeros_words(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.int32, device=resolve_device(device))


def _counts(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=count_dtype(), device=resolve_device(device))


def init_state(n_nodes: int, *, device=None) -> dict:
    """Unbounded stream state: the adjacency-so-far bitset.

    State bytes: ``4·n·ceil(n/32) ≈ n²/8`` for ``adj`` plus the int64
    ``count`` — independent of the stream length. ``device`` defaults to
    ``cuda``."""
    w = -(-n_nodes // 32)
    return {"adj": _zeros_words((n_nodes, w), device), "count": _counts((), device)}


def _mesh_of(mesh, n_stages: int):
    if mesh.size != n_stages:
        raise ValueError(f"{n_stages} stages on a mesh of {mesh.size}")
    return mesh.devices


def init_sharded_state(n_nodes: int, n_stages: int, *, device=None, mesh=None) -> dict:
    """Column-sharded state: stage s owns words [s·Ws, (s+1)·Ws) of every
    row — n·Ws·4 ≈ n²/8/S bytes per stage, S·n·Ws·4 in all when the stages
    are emulated on one device ((S, n, Ws) on ``device``). On ``mesh`` (of
    ``n_stages`` stages) ``adj`` is the list of the S (n, Ws) shards, each
    on its stage's device, and ``count`` is on stage 0's. The trailing pad
    words (W rounded up to S·Ws) map to no node and stay zero forever."""
    w = -(-n_nodes // 32)
    ws = -(-w // n_stages)
    if mesh is not None:
        devs = _mesh_of(mesh, n_stages)
        return {"adj": [_zeros_words((n_nodes, ws), d) for d in devs],
                "count": _counts((), devs[0])}
    return {"adj": _zeros_words((n_stages, n_nodes, ws), device),
            "count": _counts((), device)}


def init_windowed_state(n_nodes: int, window_epochs: int, *, device=None) -> dict:
    """Sliding-window state: a ring of E = ``window_epochs`` epoch bitsets.

    ``epochs[r]`` holds the edges that arrived while ring slot r was the
    current epoch; the LIVE adjacency is the OR over slots. ``counts[r]``
    holds the live triangles whose OLDEST edge sits in slot r (so clearing a
    slot deletes exactly the triangles that die with it — see
    ``expire_epoch``); the window's count is ``counts.sum()``
    (``window_count``). ``head`` is the int32 slot of the CURRENT epoch;
    slot age is ``(head - r) mod E``. State bytes: ``E·4·n·ceil(n/32)``
    plus E counters."""
    if window_epochs < 1:
        raise ValueError(f"window_epochs must be >= 1, got {window_epochs}")
    w = -(-n_nodes // 32)
    return {"epochs": _zeros_words((window_epochs, n_nodes, w), device),
            "counts": _counts((window_epochs,), device),
            "head": torch.zeros((), dtype=torch.int32, device=resolve_device(device))}


def init_windowed_sharded_state(n_nodes: int, window_epochs: int, n_stages: int, *,
                                device=None, mesh=None) -> dict:
    """``init_windowed_state`` with every epoch bitset column-sharded over S
    stages like ``init_sharded_state``: ``epochs`` is (S, E, n, Ws), or on
    ``mesh`` the list of the S (E, n, Ws) shards on their stages' devices;
    ``counts``/``head`` are shared (on stage 0's device on a mesh)."""
    if window_epochs < 1:
        raise ValueError(f"window_epochs must be >= 1, got {window_epochs}")
    w = -(-n_nodes // 32)
    ws = -(-w // n_stages)
    if mesh is not None:
        devs = _mesh_of(mesh, n_stages)
        epochs = [_zeros_words((window_epochs, n_nodes, ws), d) for d in devs]
        device = devs[0]
    else:
        epochs = _zeros_words((n_stages, window_epochs, n_nodes, ws), device)
    return {"epochs": epochs, "counts": _counts((window_epochs,), device),
            "head": torch.zeros((), dtype=torch.int32, device=resolve_device(device))}


def validate_edges(edges, n_nodes: int) -> np.ndarray:
    """Front-door edge validation: the (B, 2) int array contract, enforced.

    The ingest paths treat ids >= n as phantoms (silently dropped) and a
    NEGATIVE id would gather/scatter at a wrapped index — silent corruption
    of the bitset. So the session front door (``StreamSession.feed``)
    rejects anything outside the contract with a ``ValueError``:
    non-integer dtypes, shapes that are not (B, 2), and vertex ids outside
    ``[0, n_nodes)``. Returns the validated int32 (B, 2) array (zero-copy
    when already conforming); empty inputs of any shape normalize to
    (0, 2). Timed as the ``ingest.validate`` span."""
    with tracing.span("ingest.validate"):
        arr = np.asarray(edges)
        if arr.size == 0:
            return np.zeros((0, 2), np.int32)
        if not np.issubdtype(arr.dtype, np.integer):
            raise ValueError(
                f"edges must be an integer array, got dtype {arr.dtype} — vertex "
                f"ids are indices, not floats")
        if arr.ndim != 2 or arr.shape[1] != 2:
            raise ValueError(
                f"edges must have shape (B, 2) (one (u, v) pair per row), got "
                f"{arr.shape}")
        lo, hi = int(arr.min()), int(arr.max())
        if lo < 0 or hi >= n_nodes:
            raise ValueError(
                f"vertex ids must lie in [0, {n_nodes}), got range [{lo}, {hi}] "
                f"— out-of-range ids would silently scatter outside the bitset")
        return arr.astype(np.int32, copy=False)


_WORD_KEYS = ("adj", "epochs", "hub_adj")
_COUNT_KEYS = ("count", "counts")


def snapshot_state(state: dict) -> dict:
    """Bit-exact HOST copy of a streaming state (dense, sharded, windowed,
    on a mesh), in the reference's layout: bitsets as uint32 (a view of the
    int32 words), ``head`` int32, counts int64. A mesh state's shards are
    stacked into the emulated (S, ...) array, which restores onto either
    layout. Waits for every queued ingest into ``state`` (the copies
    synchronise)."""
    out = {}
    for k, v in state.items():
        if isinstance(v, list):
            a = np.stack([shard.detach().cpu().numpy() for shard in v])
        else:
            a = v.detach().cpu().numpy().copy()
        out[k] = a.view(np.uint32) if k in _WORD_KEYS else a
    return out


def restore_state(snap: dict, *, device=None, mesh=None) -> dict:
    """Device tensors of a :func:`snapshot_state` copy — the port's or the
    reference's: uint32 bitsets come back as int32 words with the same
    bits, and an int32 ``count``/``counts`` (the reference without x64) is
    widened to int64. On ``mesh`` a sharded bitset's (S, ...) array is split
    into the S shards of a mesh state, each on its stage's device, and the
    rest lands on stage 0's device. A restored stream continues
    bit-identically."""
    dev = resolve_device(device) if mesh is None else mesh.devices[0]
    out = {}
    for k, v in snap.items():
        a = np.array(v)  # a C-ordered copy, 0-d kept 0-d
        if k in _WORD_KEYS:
            a = a.view(np.int32)
        elif k in _COUNT_KEYS:
            a = a.astype(np.int64)
        if mesh is not None and k in _WORD_KEYS:
            devs = _mesh_of(mesh, a.shape[0])
            out[k] = [torch.from_numpy(a[s]).to(d) for s, d in enumerate(devs)]
        else:
            out[k] = torch.from_numpy(a).to(dev)
    return out


def state_nbytes(state: dict) -> int:
    """Total bytes of a state dict or host snapshot (a mesh state's shards
    summed) — what a checkpoint charges against the host/disk budgets."""
    return int(sum(sum(x.nbytes for x in v) if isinstance(v, list) else v.nbytes
                   for v in state.values()))


# First-use telemetry: the distinct (family, block shape, state shape,
# device) keys any ingest has run. The reference counts jit traces, one per
# such key; eager PyTorch builds nothing per key, so this counts the keys.
_INGEST_KEYS: set = set()
_INGEST_KEYS_LOCK = threading.Lock()


def ingest_trace_count() -> int:
    """Process-wide ingest telemetry: how many distinct (ingest family,
    block shape, state shape, device) keys have been ingested so far — the
    counterpart of the reference's trace count. The contract the tests pin:
    one fixed block shape is one key per ingest family, shared across
    streams, sessions and (for the windowed path) epochs."""
    return len(_INGEST_KEYS)


def _note_ingest(family: str, words: torch.Tensor, edges: torch.Tensor, *,
                 stages: tuple = ()) -> None:
    """Record one ingest's key; a mesh ingest passes ``stages`` = (S,) and
    one shard as ``words``."""
    key = (family, tuple(edges.shape), stages + tuple(words.shape), words.device.type)
    with _INGEST_KEYS_LOCK:
        _INGEST_KEYS.add(key)


def _as_edges(edges, device: torch.device) -> torch.Tensor:
    if not isinstance(edges, torch.Tensor):
        edges = torch.from_numpy(np.ascontiguousarray(edges, dtype=np.int32))
    return edges.to(device=device, dtype=torch.int32).reshape(-1, 2)


# --------------------------------------------------------------------------
# Shared per-block math (unsharded = the off=0, full-width special case)
# --------------------------------------------------------------------------
def _canonical_live(edges: torch.Tensor, n: int):
    """(keep, lo, hi): canonical int64 endpoints with self-loops and
    phantoms invalidated (lo = hi = n) and within-block duplicates reduced
    to their first occurrence (a stable sort of the key lo·(n+1)+hi).
    ``keep`` still needs the not-already-in-A check."""
    u, v = edges[:, 0].to(torch.int64), edges[:, 1].to(torch.int64)
    valid = (u < n) & (v < n) & (u != v) & (u >= 0) & (v >= 0)
    lo = torch.where(valid, torch.minimum(u, v), n)
    hi = torch.where(valid, torch.maximum(u, v), n)
    skey, order = torch.sort(lo * (n + 1) + hi, stable=True)
    dup = torch.zeros_like(valid)
    dup[1:] = skey[1:] == skey[:-1]
    first = torch.zeros_like(valid).scatter_(0, order, ~dup)
    return valid & first, lo, hi


def _stage_seen(adj_s: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                off: int) -> torch.Tensor:
    """Per-edge already-in-A bit (int32 0/1), restricted to this stage's
    word shard (exactly one stage owns word hi//32, so summing over stages
    recovers the global bit). The arithmetic shift of a negative word is
    right here because only bit 0 of the result is kept."""
    n, ws = adj_s.shape
    wl = hi // 32 - off
    owned = (wl >= 0) & (wl < ws) & (lo < n)
    word = adj_s[lo.clamp(0, n - 1), wl.clamp(0, ws - 1)]
    bit = (word >> (hi % 32).to(torch.int32)) & 1
    return torch.where(owned, bit, 0)


_BITS_ON: dict = {}


def _bits_on(device: torch.device) -> torch.Tensor:
    """``_BITS`` on ``device``, copied there once (a blocking copy per block
    would make the host wait for the card)."""
    t = _BITS_ON.get(device)
    if t is None:
        t = _BITS_ON[device] = torch.from_numpy(_BITS).to(device)
    return t


def _delta_bits(n: int, ws: int, lo: torch.Tensor, hi: torch.Tensor,
                live: torch.Tensor, off: int):
    """(flat word index, int32 bit) of every live edge's two bits on this
    stage's (n, ws) word shard; dead and unowned bits become a 0 added to
    word 0."""
    bits = _bits_on(lo.device)

    def owned(row, col):
        wl = col // 32 - off
        ok = live & (wl >= 0) & (wl < ws)
        return (torch.where(ok, row * ws + wl, 0),
                torch.where(ok, bits[col % 32], 0))

    i1, b1 = owned(lo, hi)
    i2, b2 = owned(hi, lo)
    return torch.cat([i1, i2]), torch.cat([b1, b2])


def _delta_table(n: int, ws: int, idx: torch.Tensor, bits: torch.Tensor,
                 scratch=None) -> torch.Tensor:
    """The block's delta-adjacency on one word shard (zeroed, in
    ``scratch((n·ws,))`` when given), landed in ONE scatter: dedup makes
    the bits of one word distinct, so add equals OR (and a sum of distinct
    bits never overflows int32)."""
    tracing.count("ingest.zero_fill_bytes", 4 * n * ws)
    delta = (torch.zeros(n * ws, dtype=torch.int32, device=idx.device) if scratch is None
             else scratch((n * ws,)).zero_())
    return delta.index_add_(0, idx, bits).view(n, ws)


def _phantom_edges(lo: torch.Tensor, hi: torch.Tensor, live: torch.Tensor,
                   n: int) -> torch.Tensor:
    """Dead edges become phantoms (id = n) so the kernels' validity rule
    doubles as the live mask; int32 (B, 2), as the kernels take it."""
    return torch.where(live[:, None], torch.stack([lo, hi], dim=1), n).to(torch.int32)


def _stage_update(adj_s: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                  live: torch.Tensor, off: int, scratch=None) -> torch.Tensor:
    """One stage's share of the two-phase block ingest: returns its
    (pre, mixed, dd) partials and adds the block's live bits into ``adj_s``
    in place. The caller sums shards BEFORE dividing: mixed counts every
    (block, block, pre-block) triangle twice and dd every all-in-block
    triangle three times only in full-width sums. ``scratch`` allocates the
    delta table (``_delta_table``)."""
    n, ws = adj_s.shape
    idx, bits = _delta_bits(n, ws, lo, hi, live, off)
    delta = _delta_table(n, ws, idx, bits, scratch)
    ek = _phantom_edges(lo, hi, live, n)
    pre = bitset_edge_count(adj_s, ek)
    mixed = bitset_pair_count(adj_s, delta, ek) + bitset_pair_count(delta, adj_s, ek)
    dd = bitset_edge_count(delta, ek)
    adj_s.view(-1).index_add_(0, idx, bits)
    return torch.stack([pre, mixed, dd])


def _combine(count: torch.Tensor, terms: torch.Tensor) -> None:
    # terms = full-width (pre, mixed, dd); the divisions are exact (see the
    # multiplicities in the module docstring)
    count += terms[0] + terms[1] // 2 + terms[2] // 3


# --------------------------------------------------------------------------
# Sliding-window math (shared by the dense, emulated and mesh paths)
# --------------------------------------------------------------------------
def _age_order(head: torch.Tensor, n_epochs: int) -> torch.Tensor:
    """Ring slots in AGE order, newest first: ``order[t]`` is the slot whose
    epoch is t epochs old (order[0] = head = the current epoch)."""
    ages = torch.arange(n_epochs, dtype=torch.int64, device=head.device)
    return (head.to(torch.int64) - ages) % n_epochs


def _age_cum(epochs_s: torch.Tensor, head: torch.Tensor, scratch=None) -> torch.Tensor:
    """Age-cumulative OR tables on this stage's word shard: ``cum[t]`` is
    the OR of the t+1 NEWEST epoch bitsets, so ``cum[-1]`` is the live
    adjacency. A fresh (E, n, Ws) stack (from ``scratch(shape)`` when
    given), built once per block by E − 1 ORs and shared by the dedup check
    and the phase sweeps."""
    order = _age_order(head, epochs_s.shape[0])
    cum = (epochs_s.index_select(0, order) if scratch is None
           else torch.index_select(epochs_s, 0, order, out=scratch(epochs_s.shape)))
    for t in range(1, cum.shape[0]):
        cum[t] |= cum[t - 1]
    return cum


def _windowed_stage_update(epochs_s: torch.Tensor, cum: torch.Tensor,
                           lo: torch.Tensor, hi: torch.Tensor, live: torch.Tensor,
                           off: int, head: torch.Tensor, scratch=None) -> torch.Tensor:
    """One stage's share of the windowed two-phase block ingest.

    Each age-cumulative table gets the unbounded sweep: ``P[t] = Σ_e
    pc(cum_t[u] & cum_t[v])`` counts the wedges both of whose edges are at
    age ≤ t, and ``M[t] = Σ_e pc(cum_t[u] & D[v]) + pc(D[u] & cum_t[v])``
    each (block, block, age ≤ t) triangle twice; ``dd`` is unchanged.
    Returns the (2E+1,) stack ``[P (E,), M (E,), dd]`` and adds the live
    bits into the current epoch's slot in place. The caller sums shards
    BEFORE ``_windowed_combine`` differences and divides."""
    n_epochs, n, ws = epochs_s.shape
    idx, bits = _delta_bits(n, ws, lo, hi, live, off)
    delta = _delta_table(n, ws, idx, bits, scratch)
    ek = _phantom_edges(lo, hi, live, n)
    ps, ms = [], []
    for t in range(n_epochs):  # the unbounded closures, once per epoch age
        ps.append(bitset_edge_count(cum[t], ek))
        ms.append(bitset_pair_count(cum[t], delta, ek) + bitset_pair_count(delta, cum[t], ek))
    dd = bitset_edge_count(delta, ek)
    epochs_s.view(-1).index_add_(0, head.to(torch.int64) * (n * ws) + idx, bits)
    return torch.cat([torch.stack(ps), torch.stack(ms), dd[None]])


def _windowed_combine(counts: torch.Tensor, terms: torch.Tensor, head: torch.Tensor) -> None:
    """Attribute the block's full-width (P, M, dd) sums to the per-slot
    counters, in place: ``P[t] - P[t-1]`` closures whose OLDEST wedge edge
    is exactly t epochs old, ``(M[t] - M[t-1]) // 2`` mixed triangles whose
    third edge is exactly t old, ``dd // 3`` all-in-block triangles (all
    current), each added to the slot that is t epochs old."""
    n_epochs = counts.shape[0]
    p_terms, m_terms, dd = terms[:n_epochs], terms[n_epochs:2 * n_epochs], terms[-1]
    zero = torch.zeros(1, dtype=terms.dtype, device=terms.device)
    contrib = torch.diff(p_terms, prepend=zero) + torch.diff(m_terms, prepend=zero) // 2
    contrib[0] += dd // 3
    counts.index_add_(0, _age_order(head, n_epochs), contrib)


def window_count(state: dict) -> torch.Tensor:
    """The live window's triangle count (int64 device scalar): the sum over
    the per-slot attribution counters."""
    return state["counts"].sum()


# --------------------------------------------------------------------------
# Unbounded ingest
# --------------------------------------------------------------------------
def ingest_block(state: dict, edges) -> dict:
    """Fold one (B, 2) edge block (phantom rows: id >= n_nodes) into an
    ``init_state`` state with the two-phase blocked ingest, in place, and
    return the state. Duplicate edges are ignored (the paper's simple-graph
    precondition); self-loops contribute nothing. On the card: K3 twice
    (``pre``, ``dd``) and K4 twice (``mixed``) per block; transient memory
    one (n, W) delta table."""
    adj = state["adj"]
    n = adj.shape[0]
    e = _as_edges(edges, adj.device)
    _note_ingest("blocked", adj, e)
    keep, lo, hi = _canonical_live(e, n)
    live = keep & (_stage_seen(adj, lo, hi, 0) == 0)
    _combine(state["count"], _stage_update(adj, lo, hi, live, 0))
    return state


def ingest_block_sharded(state: dict, edges) -> dict:
    """Column-sharded ingest with the S stages emulated on one device: the
    per-stage ``seen`` bits and (pre, mixed, dd) partials are summed over
    the stages (the ring's all-reduce) before the divisions. Each stage
    launches K3/K4 on its own shard. State bytes: all S shards on this
    device — n²/8 in all."""
    adj = state["adj"]  # (S, n, Ws)
    s, n, ws = adj.shape
    e = _as_edges(edges, adj.device)
    _note_ingest("sharded", adj, e)
    keep, lo, hi = _canonical_live(e, n)
    seen = sum(_stage_seen(adj[i], lo, hi, i * ws) for i in range(s))
    live = keep & (seen == 0)
    terms = sum(_stage_update(adj[i], lo, hi, live, i * ws) for i in range(s))
    _combine(state["count"], terms)
    return state


@lru_cache(maxsize=32)
def make_mesh_ingest(mesh, axis_name: str | None = None):
    """The column-sharded ingest over a ring mesh: ``ingest(state, edges)``
    folds one block into a mesh state (``init_sharded_state(..., mesh=)``)
    in place and returns it. Each stage's shard lives on its device and is
    folded on its stage's stream through the shared
    ``dynamic_pipeline.ShardedStateStream`` of the mesh: the per-stage
    ``seen`` bits and (pre, mixed, dd) partials are summed on stage 0
    between the phases, K3 twice and K4 twice per shard per block. Memoized
    per (mesh, axis), so every session on one mesh shares one ingest.
    State bytes: n²/8/S per stage; a device holds that once for each stage
    it hosts."""
    from repro_torch.core.dynamic_pipeline import ShardedStateStream

    runtime = ShardedStateStream.shared(mesh, axis_name or mesh.axis_names[0])

    def ingest(state: dict, edges) -> dict:
        shards = state["adj"]
        n, ws = shards[0].shape
        e = _as_edges(edges, mesh.devices[0])
        _note_ingest("mesh", shards[0], e, stages=(len(shards),))
        runtime.step(
            shards, e,
            canonical=lambda b: _canonical_live(b, n),
            seen=lambda s, adj_s, _, lo, hi: (_stage_seen(adj_s, lo, hi, s * ws), None),
            update=lambda s, adj_s, scratch, _, live, lo, hi: _stage_update(
                adj_s, lo, hi, live, s * ws, scratch),
            combine=lambda terms: _combine(state["count"], terms))
        return state

    return ingest


# --------------------------------------------------------------------------
# Sliding-window ingest: the epoch ring (dense / emulated-sharded)
# --------------------------------------------------------------------------
def ingest_block_windowed(state: dict, edges) -> dict:
    """Fold one (B, 2) edge block into the CURRENT epoch of a windowed
    state, in place, and return the state.

    Duplicates of a STILL-LIVE edge are ignored wherever that edge's epoch
    sits (the window keeps each live edge's first arrival); an edge whose
    earlier arrival has expired is new and lands in the current epoch.
    Per-slot attribution is exact, so ``window_count`` equals a recount of
    the live window after every block. Transient memory: the E
    age-cumulative tables and one delta table."""
    epochs = state["epochs"]
    n = epochs.shape[1]
    e = _as_edges(edges, epochs.device)
    _note_ingest("windowed", epochs, e)
    head = state["head"]
    keep, lo, hi = _canonical_live(e, n)
    cum = _age_cum(epochs, head)  # cum[-1] = live adjacency
    live = keep & (_stage_seen(cum[-1], lo, hi, 0) == 0)
    terms = _windowed_stage_update(epochs, cum, lo, hi, live, 0, head)
    _windowed_combine(state["counts"], terms, head)
    return state


def ingest_block_windowed_sharded(state: dict, edges) -> dict:
    """Column-sharded windowed ingest, the S stages emulated on one device:
    the (P, M, dd) partials are summed over the shards BEFORE
    ``_windowed_combine`` differences and divides."""
    epochs = state["epochs"]  # (S, E, n, Ws)
    s, _, n, ws = epochs.shape
    e = _as_edges(edges, epochs.device)
    _note_ingest("windowed_sharded", epochs, e)
    head = state["head"]
    keep, lo, hi = _canonical_live(e, n)
    cums = [_age_cum(epochs[i], head) for i in range(s)]
    seen = sum(_stage_seen(cums[i][-1], lo, hi, i * ws) for i in range(s))
    live = keep & (seen == 0)
    terms = sum(_windowed_stage_update(epochs[i], cums[i], lo, hi, live, i * ws, head)
                for i in range(s))
    _windowed_combine(state["counts"], terms, head)
    return state


@lru_cache(maxsize=32)
def make_mesh_ingest_windowed(mesh, axis_name: str | None = None):
    """The column-sharded WINDOWED ingest over a ring mesh, on the same
    runtime as :func:`make_mesh_ingest`: each stage builds its shard's
    age-cumulative tables and ``seen`` bits, the (P, M, dd) partials are
    summed on stage 0 BEFORE ``_windowed_combine`` differences and divides,
    and ``counts``/``head`` stay on stage 0 (the head reaches each stage
    with the block's endpoints). E·n²/8/S bytes per stage."""
    from repro_torch.core.dynamic_pipeline import ShardedStateStream

    runtime = ShardedStateStream.shared(mesh, axis_name or mesh.axis_names[0])

    def seen(s, epochs_s, scratch, lo, hi, head):
        cum = _age_cum(epochs_s, head, scratch)  # cum[-1] = this shard's live words
        return _stage_seen(cum[-1], lo, hi, s * epochs_s.shape[2]), cum

    def update(s, epochs_s, scratch, cum, live, lo, hi, head):
        return _windowed_stage_update(epochs_s, cum, lo, hi, live,
                                      s * epochs_s.shape[2], head, scratch)

    def ingest(state: dict, edges) -> dict:
        shards, head = state["epochs"], state["head"]
        n = shards[0].shape[1]
        e = _as_edges(edges, mesh.devices[0])
        _note_ingest("mesh_windowed", shards[0], e, stages=(len(shards),))
        runtime.step(
            shards, e, canonical=lambda b: (*_canonical_live(b, n), head), seen=seen,
            update=update,
            combine=lambda terms: _windowed_combine(state["counts"], terms, head))
        return state

    return ingest


def expire_epoch(state: dict) -> dict:
    """Slide the window by one epoch, in place: move the ring head onto the
    OLDEST slot and clear it (bitset and count slot). This is the whole
    deletion story — the cleared slot held exactly the edges older than the
    new window, and the oldest-edge attribution guarantees its count slot
    held exactly the triangles those edges supported. One slot is written,
    however many edges die; the head stays on the device, so nothing syncs.
    Works on dense, sharded and mesh windowed states."""
    epochs, counts, head = state["epochs"], state["counts"], state["head"]
    slot = ((head.to(torch.int64) + 1) % counts.shape[0]).reshape(1)
    for shard in epochs if isinstance(epochs, list) else [epochs]:
        # the E axis of (..., E, n, W); a mesh state clears it in every shard
        shard.index_fill_(shard.dim() - 3, slot.to(shard.device), 0)
    counts.index_fill_(0, slot, 0)
    head.copy_(slot[0])
    return state


# --------------------------------------------------------------------------
# Per-edge fold — the oracle
# --------------------------------------------------------------------------
def ingest_block_per_edge(state: dict, edges) -> dict:
    """The per-edge fold: each edge sees exactly the adjacency before it.
    Retained as the differential ORACLE for the blocked, sharded and
    windowed ingests; it runs on the host (the state is copied there and
    back), one edge at a time. Same state layout as ``ingest_block``."""
    adj_t = state["adj"]
    n = adj_t.shape[0]
    e = _as_edges(edges, torch.device("cpu"))
    _note_ingest("per_edge", adj_t, e)
    adj = adj_t.cpu().numpy().view(np.uint32).copy()
    total = 0
    for u, v in e.tolist():
        if u >= n or v >= n or u == v or u < 0 or v < 0:
            continue
        if (adj[u, v >> 5] >> np.uint32(v & 31)) & 1:
            continue  # duplicate of an edge already present
        total += int(np.unpackbits((adj[u] & adj[v]).view(np.uint8)).sum())
        adj[u, v >> 5] |= np.uint32(1) << np.uint32(v & 31)
        adj[v, u >> 5] |= np.uint32(1) << np.uint32(u & 31)
    adj_t.copy_(torch.from_numpy(adj.view(np.int32)))
    state["count"] += total
    return state


# --------------------------------------------------------------------------
# Re-blocking
# --------------------------------------------------------------------------
class BlockBuffer:
    """Incremental re-blocking: push ragged edge arrays in, pop fixed-shape
    blocks out — ``padded_blocks`` as a handle instead of a generator, so a
    serving session can interleave with other sessions.

    Every full block has ``block_size`` rows; the trailing remainder is
    padded with phantom edges (id = n_nodes, which every ingest treats as
    invalid); a stream that ends before ever filling one block is padded to
    the next power of two instead (a 100-edge stream under a planner-sized
    1M block must not scan 1M phantom rows). ``block_size=None`` adopts the
    first non-empty push's row count. Emitted blocks are int32 tensors on
    ``device`` (default ``cuda``): the host-to-device copy is the
    producer's, queued from pinned memory.

    OWNERSHIP (single producer, single consumer — enforced): at any moment
    exactly ONE thread may be inside a mutating call (``push`` / ``flush`` /
    ``set_block_size``); a mutating call that finds another one in flight
    raises ``RuntimeError`` at once (a non-blocking try-lock, so it cannot
    deadlock). Overlapping mutators would corrupt the sticky tail silently.
    """

    def __init__(self, n_nodes: int, block_size: int | None = None, *, device=None):
        self.n_nodes = n_nodes
        self.block_size = block_size
        self.device = resolve_device(device)
        self._buf: list[np.ndarray] = []
        self._buffered = 0
        self._emitted_full = False
        self._tail_target = 0  # sticky pow2 tail shape across repeated flushes
        self._owner = threading.Lock()  # SPSC guard: held only DURING a call

    def _acquire(self, op: str):
        if not self._owner.acquire(blocking=False):
            raise RuntimeError(
                f"BlockBuffer.{op}() while another mutating call is in "
                f"flight — the buffer is single-producer/single-consumer; "
                f"concurrent push/flush silently corrupts the sticky tail "
                f"(quiesce the producer before touching the buffer from "
                f"another thread)")

    def export_shape_state(self) -> dict:
        """The re-blocking continuity a session checkpoint carries: the
        adopted ``block_size`` plus the sticky tail-shape state, so a
        restored buffer emits exactly the shapes the original would have.
        (The buffered edges are not exported: ``checkpoint()`` flushes the
        tail first.)"""
        return {"block_size": self.block_size,
                "tail_target": self._tail_target,
                "emitted_full": self._emitted_full}

    def import_shape_state(self, shape_state: dict) -> None:
        """Adopt a checkpointed buffer's shape continuity."""
        self.block_size = shape_state["block_size"]
        self._tail_target = shape_state["tail_target"]
        self._emitted_full = shape_state["emitted_full"]

    def _emit(self, rows: np.ndarray, real: int) -> torch.Tensor:
        """``rows`` on the device; the first ``real`` of them are edges fed,
        the rest phantom padding (the ``ingest.rows_real`` and
        ``ingest.rows_padded`` counters)."""
        tracing.count("ingest.rows_real", real)
        tracing.count("ingest.rows_padded", len(rows) - real)
        t = torch.from_numpy(np.ascontiguousarray(rows))
        if self.device.type == "cuda":
            # from pinned memory the copy is queued and the host goes on;
            # a pageable copy would wait for the card's earlier work
            with tracing.span("ingest.pin"):
                t = t.pin_memory()
            with tracing.span("ingest.h2d"):
                return t.to(self.device, non_blocking=True)
        return t.to(self.device)

    def _drain(self) -> list[torch.Tensor]:
        out = []
        while self._buffered >= self.block_size:
            flat = np.concatenate(self._buf) if len(self._buf) > 1 else self._buf[0]
            chunk, rest = flat[: self.block_size], flat[self.block_size:]
            self._buf, self._buffered = ([rest], len(rest)) if len(rest) else ([], 0)
            self._emitted_full = True
            out.append(self._emit(chunk, len(chunk)))
        return out

    def push(self, block) -> list[torch.Tensor]:
        """Buffer ``block``; return every full ``block_size`` block it
        completed (possibly none). Raises ``RuntimeError`` when another
        mutating call is in flight."""
        self._acquire("push")
        try:
            b = np.asarray(block, dtype=np.int32).reshape(-1, 2)
            if len(b) == 0:
                return []
            if self.block_size is None:
                self.block_size = len(b)
            self._buf.append(b)
            self._buffered += len(b)
            return self._drain()
        finally:
            self._owner.release()

    def set_block_size(self, block_size: int) -> list[torch.Tensor]:
        """Adaptive re-blocking: switch the emitted full-block shape from
        the NEXT block on (counts are invariant to re-blocking). The
        buffered remainder re-chunks at once; the blocks it completes are
        returned as by :meth:`push`."""
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self._acquire("set_block_size")
        try:
            self.block_size = int(block_size)
            self._emitted_full = False  # let a small tail keep its pow2 shape
            return self._drain()
        finally:
            self._owner.release()

    def flush(self) -> torch.Tensor | None:
        """The padded tail block (None if nothing is buffered). Call at end
        of stream — or at every epoch boundary of a windowed session: the
        power-of-two tail shape is STICKY (remembered and only ever grown),
        so repeated flushes of similar-size tails reuse one shape. Raises
        ``RuntimeError`` when another mutating call is in flight."""
        self._acquire("flush")
        try:
            if not self._buffered:
                return None
            flat = np.concatenate(self._buf) if len(self._buf) > 1 else self._buf[0]
            self._buf, self._buffered = [], 0
            if self._emitted_full:
                target = self.block_size
            else:  # never filled a block: one power-of-two shape, not block_size
                target = max(self._tail_target, 8)
                while target < min(len(flat), self.block_size):
                    target *= 2
                target = min(target, self.block_size)
                self._tail_target = target
            pad = np.full((target - len(flat), 2), self.n_nodes, np.int32)
            return self._emit(np.concatenate([flat, pad]), len(flat))
        finally:
            self._owner.release()


class AdaptiveBlockSizer:
    """Grow/shrink the ingest block size from observed wall-clock — the
    paper's dynamic-pipeline "growing and shrinking" analogue, applied to
    re-blocking: a block that dispatches too fast is dominated by per-call
    overhead (grow ×2 to amortize it), one that runs too long hurts latency
    and working set (shrink ÷2).

    Sizes move in POWER-OF-TWO steps inside ``[lo, hi]`` where ``hi`` is the
    plan's block size rounded up to a power of two and ``lo`` defaults to
    ``max(hi // 8, 256)``, so at most ``log2(hi/lo) + 1`` block shapes can
    ever be proposed. ``observe(n_edges, wall_s)`` feeds one measured
    ingest; a resize is proposed only after ``patience`` consecutive
    observations agree (hysteresis). Returns the new size when a change is
    due, else None. Pure host arithmetic, as in the reference.

    On the card the observed wall is the host's dispatch of the ingest, not
    its device time (launches are asynchronous), so a block reads as fast
    and the size stays at ``hi``; no sync is added to make it move."""

    def __init__(self, plan_block_size: int, *, lo: int | None = None,
                 low_s: float = 2e-3, high_s: float = 20e-3,
                 patience: int = 3):
        hi = 1 << max(int(plan_block_size) - 1, 0).bit_length()  # pow2 >= plan
        self.hi = max(hi, 1)
        self.lo = max(1, min(lo if lo is not None else max(hi // 8, 256),
                             self.hi))
        self.low_s = low_s
        self.high_s = high_s
        self.patience = patience
        self.size = self.hi
        self._streak = 0  # +k fast observations in a row, -k slow

    def observe(self, n_edges: int, wall_s: float) -> int | None:
        """One measured ingest of ``n_edges`` rows in ``wall_s`` seconds.
        Returns the NEW block size when ``patience`` consecutive
        observations agree a resize helps (the caller applies it through
        ``BlockBuffer.set_block_size``), else None."""
        if n_edges <= 0:
            return None
        if wall_s < self.low_s and self.size * 2 <= self.hi:
            self._streak = self._streak + 1 if self._streak > 0 else 1
            if self._streak >= self.patience:
                self._streak = 0
                self.size *= 2
                return self.size
        elif wall_s > self.high_s and self.size // 2 >= self.lo:
            self._streak = self._streak - 1 if self._streak < 0 else -1
            if -self._streak >= self.patience:
                self._streak = 0
                self.size //= 2
                return self.size
        else:
            self._streak = 0
        return None


def padded_blocks(blocks, n_nodes: int, block_size: int | None = None, *, device=None):
    """Normalize an iterable of (B, 2) edge blocks to ONE fixed block shape
    (the pull-based rendering of :class:`BlockBuffer` — see it for the shape
    policy). The count is invariant to the re-blocking."""
    buf = BlockBuffer(n_nodes, block_size, device=device)
    for block in blocks:
        yield from buf.push(block)
    tail = buf.flush()
    if tail is not None:
        yield tail


# --------------------------------------------------------------------------
# Whole streams (the core-level twins of the counter's entry points)
# --------------------------------------------------------------------------
def count_stream(n_nodes: int, blocks, *, block_size: int | None = None,
                 n_stages: int = 1, mesh=None, device=None) -> int:
    """Consume an iterable of (B, 2) numpy edge blocks and return the exact
    triangle count, host-synced, without materializing the edge list.
    Blocks are coalesced/padded to one fixed shape (``padded_blocks``).
    ``n_stages > 1`` column-shards the state over the stages: on ``mesh``
    when its size matches (each shard on its stage's device, blocks on
    stage 0's), else emulated on ``device`` (default ``cuda``)."""
    if n_stages > 1 and mesh is not None and mesh.size == n_stages:
        state = init_sharded_state(n_nodes, n_stages, mesh=mesh)
        step, device = make_mesh_ingest(mesh), mesh.devices[0]
    elif n_stages > 1:
        state = init_sharded_state(n_nodes, n_stages, device=device)
        step = ingest_block_sharded
    else:
        state = init_state(n_nodes, device=device)
        step = ingest_block
    for block in padded_blocks(blocks, n_nodes, block_size, device=device):
        step(state, block)
    return int(state["count"])


def count_stream_per_edge(n_nodes: int, blocks, *, block_size: int | None = None,
                          device=None) -> int:
    """The per-edge fold over the same re-blocked stream — the oracle twin
    of ``count_stream``."""
    state = init_state(n_nodes, device=device)
    for block in padded_blocks(blocks, n_nodes, block_size, device=device):
        ingest_block_per_edge(state, block)
    return int(state["count"])


def count_windowed_stream(n_nodes: int, epochs, window_epochs: int, *,
                          block_size: int | None = None, n_stages: int = 1,
                          mesh=None, device=None) -> int:
    """Consume an iterable of EPOCHS — each an iterable of (B, 2) numpy edge
    blocks — and return the triangle count of the final window (the last
    ``window_epochs`` epochs), host-synced. One :class:`BlockBuffer` spans
    the epochs (each epoch's tail flushes at its boundary; the tail shape is
    sticky), and ``expire_epoch`` slides the window between epochs.
    ``n_stages > 1`` shards every epoch bitset as :func:`count_stream`
    shards its state, on ``mesh`` when its size matches."""
    if n_stages > 1 and mesh is not None and mesh.size == n_stages:
        state = init_windowed_sharded_state(n_nodes, window_epochs, n_stages, mesh=mesh)
        step, device = make_mesh_ingest_windowed(mesh), mesh.devices[0]
    elif n_stages > 1:
        state = init_windowed_sharded_state(n_nodes, window_epochs, n_stages, device=device)
        step = ingest_block_windowed_sharded
    else:
        state = init_windowed_state(n_nodes, window_epochs, device=device)
        step = ingest_block_windowed
    buf = BlockBuffer(n_nodes, block_size, device=device)
    first = True
    for epoch_blocks in epochs:
        if not first:  # close the previous epoch: flush its tail, slide
            tail = buf.flush()
            if tail is not None:
                step(state, tail)
            expire_epoch(state)
        first = False
        for block in epoch_blocks:
            for b in buf.push(block):
                step(state, b)
    tail = buf.flush()
    if tail is not None:
        step(state, tail)
    return int(window_count(state))


# --------------------------------------------------------------------------
# Degree-aware hybrid state: bitset rows for hubs, fixed-capacity sorted
# adjacency buffers for the long tail — the escape from the n²/8 wall
# --------------------------------------------------------------------------
def init_hybrid_state(n_nodes: int, hub_slots: int, tail_capacity: int, *,
                      device=None) -> dict:
    """Hybrid streaming state: ``hub_slots`` full bitset rows reserved for
    high-degree vertices plus a sorted-adjacency buffer of ``tail_capacity``
    neighbor slots per vertex for the long tail. The reference's layout:

    - ``hub_adj``  (H, W) int32 words (the uint32 bit pattern) — one
      full-width bitset row per hub slot; a free slot's row is all zero
    - ``hub_ids``  (H,)   — vertex owning each slot (sentinel n = free)
    - ``hub_slot`` (n,)   — slot index per vertex (-1 = tail vertex)
    - ``tail_nbr`` (n, C) — sorted neighbor ids, sentinel n past the fill
    - ``deg``      (n,)   — streamed degree so far (the promotion sketch)
    - ``count`` int64 running total; ``lost`` int32 — edge endpoints
      DROPPED on capacity exhaustion (must stay 0: finalize and checkpoint
      refuse a lossy session)

    State bytes: exactly :func:`hybrid_state_nbytes`, linear in n instead
    of the dense n²/8 whenever C ≪ n/8. ``device`` defaults to ``cuda``."""
    if hub_slots < 1:
        raise ValueError(f"hub_slots must be >= 1, got {hub_slots}")
    if tail_capacity < 1:
        raise ValueError(f"tail_capacity must be >= 1, got {tail_capacity}")
    dev = resolve_device(device)
    w = -(-n_nodes // 32)
    i32 = dict(dtype=torch.int32, device=dev)
    return {"hub_adj": torch.zeros((hub_slots, w), **i32),
            "hub_ids": torch.full((hub_slots,), n_nodes, **i32),
            "hub_slot": torch.full((n_nodes,), -1, **i32),
            "tail_nbr": torch.full((n_nodes, tail_capacity), n_nodes, **i32),
            "deg": torch.zeros((n_nodes,), **i32),
            "count": _counts((), dev),
            "lost": torch.zeros((), **i32)}


def hybrid_state_nbytes(n_nodes: int, hub_slots: int, tail_capacity: int) -> int:
    """EXACT device bytes of :func:`init_hybrid_state` — ``hub_slots``
    full bitset rows (H, W) int32 plus their owner ids (H,), per-vertex hub
    slots (n,), ``tail_capacity`` neighbor slots per vertex (n, C) and
    degrees (n,), all int32, then the running count (``count_dtype()``, int64
    here) and the int32 ``lost`` counter — the formula the planner charges
    at admission."""
    w = -(-n_nodes // 32)
    scalar = count_dtype().itemsize
    return 4 * (hub_slots * w + hub_slots + n_nodes * (tail_capacity + 2)) \
        + scalar + 4


def _tail_rows(table: torch.Tensor, rows: torch.Tensor, nbrs: torch.Tensor,
               keep: torch.Tensor, n: int) -> None:
    """Add the bits of the tail buffers ``nbrs`` (R, C) into rows ``rows``
    (R,) of ``table`` (·, W), in place, where ``keep`` (R,) holds — the
    reference's expansion of tail buffers into full-width bitset rows,
    landed in the table that needs them instead of fresh (R, W) zeros.

    A buffer's ids are distinct and its target row holds none of their
    bits, so add equals OR. The sentinel n (and every dropped row) adds 0
    to word 0: never ``n // 32``, which is a real word whenever n % 32 ≠ 0
    (the reference maps the sentinel to word W, one past the end, where
    JAX drops the scatter)."""
    w = table.shape[1]
    real = keep[:, None] & (nbrs < n)
    idx = torch.where(real, rows[:, None] * w + nbrs // 32, 0)
    bit = torch.where(real, _bits_on(table.device)[nbrs % 32], 0)
    table.view(-1).index_add_(0, idx.reshape(-1), bit.reshape(-1))


def _set_where(dst: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor, val) -> None:
    """``dst[idx[i]] = val[i]`` for every i where ``ok[i]``, in place and
    without a host sync. The ``ok`` indices must be distinct: adding
    ``val - dst[idx]`` then sets them (exact in two's complement). Every
    other entry adds 0 to row 0 — the reference sends it out of bounds,
    where JAX drops a scatter and PyTorch would raise."""
    i = torch.where(ok, idx, 0)
    old = dst[i]
    okb = ok.view(-1, *([1] * (old.dim() - 1)))
    dst.index_add_(0, i, torch.where(okb, val - old, 0))


# Words of the block-local A table packed per step on the way to ``aloc``:
# bounds its (rows, L) int32 gather to 256 MB whatever the block size.
_ALOC_WORDS = 1 << 26


def _pack_local(table: torch.Tensor, gvert: torch.Tensor, n: int, wl: int) -> torch.Tensor:
    """A restricted to the block's vertex columns, packed to words: bit b of
    ``aloc[r, j]`` is bit ``gvert[32j + b]`` of full-width row r of
    ``table`` (0 past the block's vertices and for the dead id n). The
    reference's ``abit`` (2B, 2B) and its (2B, Wl, 32) shift, a slab of
    rows at a time; the bits of a word are distinct, so their int32 sum
    is their OR."""
    big, w = table.shape
    cols = wl * 32
    k = min(big, cols)  # local ids >= cols do not occur (gvert is n there)
    real = torch.zeros(cols, dtype=torch.bool, device=table.device)
    real[:k] = gvert[:k] < n
    gv = torch.zeros(cols, dtype=torch.int64, device=table.device)
    gv[:k] = gvert[:k].clamp(max=n - 1)
    word, shift = gv // 32, (gv % 32).to(torch.int32)
    place = torch.where(real, _bits_on(table.device).repeat(wl), 0)
    aloc = torch.empty((big, wl), dtype=torch.int32, device=table.device)
    step = max(1, _ALOC_WORDS // cols)
    for r in range(0, big, step):
        g = table[r:r + step].index_select(1, word)
        g >>= shift
        g &= 1  # >> on int32 is arithmetic: keep bit 0 only
        g *= place
        aloc[r:r + step] = g.view(-1, wl, 32).sum(-1, dtype=torch.int32)
    return aloc


def ingest_block_hybrid(state: dict, edges, *, hub_threshold: int) -> dict:
    """Fold one (B, 2) edge block into a HYBRID state, in place, and return
    the state — the same two-phase ``pre + mixed//2 + dd//3`` contract as
    ``ingest_block``, bit for bit with the reference, without ever
    materialising an (n, W) table.

    Phase 1 gathers the full-width pre-block rows of the 2B endpoints into
    ONE (2B, W) table (hub rows verbatim, tail buffers expanded), rows
    [0, B) the lower and [B, 2B) the higher endpoint of each edge, and
    closes edge e against rows (e, B + e) with the per-edge kernel (K5).
    Phase 2 works in a BLOCK-LOCAL vertex space: the block delta D only
    touches block endpoints, so D and A restricted to block-vertex columns
    are packed into (2B, ceil(min(2B, n + 1)/32)) word tables, and the two-table
    closure (K4, twice) gives ``mixed`` and the one-table closure (K3) on D
    gives ``dd``, with the dense multiplicities. On the card that is one K5,
    two K4 and one K3 launch per block; on the CPU their plain versions.

    PROMOTION runs before insertion: a tail vertex whose streamed degree
    would exceed its buffer (mandatory) or reaches ``hub_threshold``
    (policy) claims a free hub slot, mandatory promotions first; its
    buffer's bits go into the slot's (zero) row and the buffer is cleared.
    Only when every slot is taken AND a buffer still overflows are edge
    endpoints dropped, counted in ``lost`` on the device (read only at
    checkpoint and finalize). Transient memory: the (2B, W) table, a
    256 MB slab of the packing, and O(B·C + B²/8) block-local words."""
    hub_adj, hub_ids = state["hub_adj"], state["hub_ids"]
    hub_slot, tail_nbr, deg = state["hub_slot"], state["tail_nbr"], state["deg"]
    n = hub_slot.shape[0]
    h, w = hub_adj.shape
    c = tail_nbr.shape[1]
    dev = hub_adj.device
    e = _as_edges(edges, dev)
    _note_ingest("hybrid", hub_adj, e)
    b = e.shape[0]
    big = 2 * b
    bits = _bits_on(dev)
    ar = torch.arange(b, device=dev)
    keep, lo, hi = _canonical_live(e, n)

    # ---- phase 1: pre-block rows of the 2B endpoints, one (2B, W) table ----
    ends = torch.cat([lo, hi])
    real_end = ends < n
    gv_end = ends.clamp(max=n - 1)
    slot = torch.where(real_end, hub_slot[gv_end], -1)
    table = hub_adj.index_select(0, slot.clamp(min=0).to(torch.int64))
    table.masked_fill_((slot < 0)[:, None], 0)
    _tail_rows(table, torch.arange(big, device=dev), tail_nbr[gv_end], real_end & (slot < 0), n)

    # dedup against A: bit hi of lo's row (rows are symmetric by insertion)
    word = table[ar, (hi // 32).clamp(max=w - 1)]
    live = keep & (((word >> (hi % 32).to(torch.int32)) & 1) == 0)
    pair = torch.stack([ar, ar + b], dim=1)
    pre = bitset_edge_count_per_edge(table, torch.where(live[:, None], pair, big).to(torch.int32))

    # ---- block-local vertex space for the intra-block correction ----
    # local ids count the block's distinct endpoints plus the dead id n, so
    # at most min(2B, n + 1) columns (the reference packs 2B)
    wl = -(-min(big, n + 1) // 32)
    rlo, rhi = torch.where(live, lo, n), torch.where(live, hi, n)
    verts = torch.cat([rlo, rhi])       # one occurrence per endpoint
    others = torch.cat([rhi, rlo])      # the occurrence's neighbor
    liveo = torch.cat([live, live])
    sv, order = torch.sort(verts, stable=True)
    firsts = torch.ones(big, dtype=torch.bool, device=dev)
    firsts[1:] = sv[1:] != sv[:-1]
    lid_sorted = torch.cumsum(firsts, 0) - 1
    lid = torch.empty(big, dtype=torch.int64, device=dev)
    lid[order] = lid_sorted
    # global vertex per local id (dead occurrences share the id of value n);
    # equal local ids write equal values
    gvert = torch.full((big,), n, dtype=torch.int64, device=dev)
    gvert[lid_sorted] = sv
    l_lo, l_hi = lid[:b], lid[b:]

    # D in local space: each live edge's two bits, in one scatter (distinct
    # bits, so add equals OR; dead edges add 0 to word 0)
    didx = torch.cat([torch.where(live, l_lo * wl + l_hi // 32, 0),
                      torch.where(live, l_hi * wl + l_lo // 32, 0)])
    dbit = torch.cat([torch.where(live, bits[l_hi % 32], 0),
                      torch.where(live, bits[l_lo % 32], 0)])
    tracing.count("ingest.zero_fill_bytes", 4 * big * wl)
    dloc = torch.zeros(big * wl, dtype=torch.int32, device=dev).index_add_(
        0, didx, dbit).view(big, wl)
    aloc = _pack_local(table, gvert, n, wl)
    del table

    def closure(u, v):
        return torch.where(live[:, None], torch.stack([u, v], dim=1), big).to(torch.int32)

    mixed = (bitset_pair_count(aloc, dloc, closure(ar, l_hi))
             + bitset_pair_count(dloc, aloc, closure(l_lo, ar + b)))
    dd = bitset_edge_count(dloc, closure(l_lo, l_hi))
    _combine(state["count"], torch.stack([pre, mixed, dd]))

    # ---- promotion (BEFORE insertion, on pre-block buffers) ----
    occ = torch.zeros(big, dtype=torch.int32, device=dev).index_add_(
        0, torch.where(liveo, lid, 0), liveo.to(torch.int32))
    real = gvert < n
    gv = gvert.clamp(max=n - 1)
    is_tail = real & (hub_slot[gv] < 0)
    newdeg = torch.where(real, deg[gv], 0) + occ
    touched = is_tail & (occ > 0)
    must = touched & (newdeg > c)            # buffer would overflow
    want = touched & (newdeg >= hub_threshold)
    cand = must | want
    free = hub_ids == n
    # mandatory promotions claim free slots before policy ones
    mrank = torch.cumsum(must, 0) - 1
    wrank = must.sum() + torch.cumsum(cand & ~must, 0) - 1
    prank = torch.where(must, mrank, wrank)
    free_first = torch.argsort((~free).to(torch.int32), stable=True)
    slot_for = free_first[prank.clamp(0, h - 1)]
    ok = cand & (prank < free.sum()) & (prank < h)
    buffers = tail_nbr[gv]
    _tail_rows(hub_adj, slot_for, buffers, ok, n)   # free slots hold zero rows
    _set_where(hub_ids, slot_for, ok, gvert.to(torch.int32))
    _set_where(hub_slot, gv, ok, slot_for.to(torch.int32))
    _set_where(tail_nbr, gv, ok, n)

    # ---- insertion (hub rows get bits, tail buffers get sorted ids) ----
    vc = verts.clamp(max=n - 1)
    slot_now = torch.where(liveo, hub_slot[vc], -1)
    to_hub = liveo & (slot_now >= 0)
    # live edges are deduped and absent from A, so the added bits are
    # distinct and unset: add == bitwise-or (promoted rows included)
    hub_adj.view(-1).index_add_(
        0, torch.where(to_hub, slot_now.to(torch.int64) * w + (others // 32).clamp(max=w - 1), 0),
        torch.where(to_hub, bits[others % 32], 0))
    to_tail = liveo & (slot_now < 0)
    # arrival rank of each occurrence within its vertex's block segment
    pos_in_order = torch.arange(big, device=dev)
    first_pos = torch.full((big,), big, dtype=torch.int64, device=dev).scatter_reduce_(
        0, lid_sorted, pos_in_order, "amin", include_self=True)
    rank = torch.empty(big, dtype=torch.int64, device=dev)
    rank[order] = pos_in_order - first_pos[lid_sorted]
    pos = torch.where(liveo, deg[vc], 0) + rank
    fits = to_tail & (pos < c)
    _set_where(tail_nbr.view(-1), vc * c + pos.clamp(0, c - 1), fits, others.to(torch.int32))
    state["lost"] += (to_tail & (pos >= c)).sum().to(torch.int32)  # slots AND buffer full

    # keep touched tail buffers sorted (sentinel n sorts past the fill):
    # canonical layout -> bit-identical checkpoints regardless of feed order
    still_tail = real & (hub_slot[gv] < 0) & touched
    _set_where(tail_nbr, gv, still_tail, torch.sort(tail_nbr[gv], dim=1).values)
    deg.index_add_(0, torch.where(liveo, vc, 0), liveo.to(torch.int32))
    return state


def hybrid_lost(state: dict) -> int:
    """Host-synced dropped-endpoint counter of a hybrid state — must be 0
    for the count to be exact; finalize and checkpoint raise when it is
    not (capacity exhaustion is a sizing bug, never a silent undercount).
    The same read brings the hub slots in use, added to the
    ``hybrid.hubs_used`` counter while the tracer is on."""
    n = state["hub_slot"].shape[0]
    lost, hubs = torch.stack([state["lost"].to(torch.int64),
                              (state["hub_ids"] < n).sum()]).tolist()
    tracing.count("hybrid.hubs_used", hubs)
    return lost


def count_stream_hybrid(n_nodes: int, blocks, *, hub_slots: int, tail_capacity: int,
                        hub_threshold: int | None = None, block_size: int | None = None,
                        device=None) -> int:
    """Consume an iterable of (B, 2) numpy edge blocks through the HYBRID
    state — the differential twin of :func:`count_stream`. Raises if any
    edge endpoint was dropped (hub slots exhausted while a tail buffer
    overflowed) instead of returning an undercount. ``hub_threshold``
    defaults to ``tail_capacity`` (promote exactly when the buffer fills).
    ``device`` defaults to ``cuda``."""
    state = init_hybrid_state(n_nodes, hub_slots, tail_capacity, device=device)
    t = tail_capacity if hub_threshold is None else hub_threshold
    for block in padded_blocks(blocks, n_nodes, block_size, device=device):
        ingest_block_hybrid(state, block, hub_threshold=t)
    lost = hybrid_lost(state)
    if lost:
        raise RuntimeError(
            f"hybrid stream dropped {lost} edge endpoint(s): {hub_slots} hub "
            f"slots exhausted while tail buffers of {tail_capacity} "
            f"overflowed — resize hub_slots/tail_capacity")
    return int(state["count"])
