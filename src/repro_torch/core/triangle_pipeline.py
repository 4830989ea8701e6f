"""Dynamic-pipeline triangle counting (the paper's contribution) on the GPU.

Counting semantics (equal to Aráoz–Zoltan's filter semantics): fix any
total order on nodes; the filter responsible for rank r counts streamed
edges (u, v) with u, v ∈ fwd_adj(r); each triangle is counted exactly once,
at its min-rank vertex. Four execution paths:

- dense:   Δ = sum(U ⊙ (U @ U)) with U the strictly upper triangular
           rank-permuted adjacency — the live-grid CUDA kernel.
- ring:    row blocks of U are the stage-resident filters; the blocks
           themselves stream through every stage (``dynamic_pipeline``:
           the stage chain, or the ring on a mesh), each visit one masked
           matmul-sum kernel launch.
- sparse:  padded sorted forward-adjacency + per-edge sorted intersection —
           the memory-bound path for huge sparse graphs (NY road network).
- bitset:  stage-resident membership bitmasks; *edge blocks* stream through
           the stages and are closed against each stage's responsible set —
           the most literal rendering of the paper's edge streaming.

Every count is int64 on the operands' device. The kernels are chosen by the
tensors' device: a CUDA tensor launches the CUDA kernel, a CPU tensor runs
its plain PyTorch version.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from repro_torch.core.dynamic_pipeline import FilterSpec, mesh_runtime, run_sequential
from repro_torch.core.partition import RingPartition, ring_partition
from repro_torch.graphs.formats import Graph
from repro_torch.kernels.bitset_count.ops import bitset_edge_count
from repro_torch.kernels.triangle_count.ops import masked_matmul_sum, triangle_count
from repro_torch.utils import count_dtype, resolve_device


# --------------------------------------------------------------------------
# Dense single-device path
# --------------------------------------------------------------------------
def count_triangles_dense(u: torch.Tensor, *, live_grid: bool = True) -> torch.Tensor:
    """sum(U ⊙ (U @ U)) — U strictly upper triangular 0/1 uint8, (n, n) or a
    (B, n, n) batch. Integer arithmetic throughout: an f32 total silently
    loses exactness past 2²⁴ triangles."""
    return triangle_count(u, live_grid=live_grid)


# --------------------------------------------------------------------------
# Sparse single-device path (per-edge sorted intersection)
# --------------------------------------------------------------------------
def count_triangles_sparse(nbrs: torch.Tensor, edges: torch.Tensor, *,
                           edge_batch: int = 4096) -> torch.Tensor:
    """Forward-edge intersection count.

    nbrs:  (n_pad, md) int32 — sorted forward neighbors in rank space, padded
           with a sentinel larger than any real rank (use n_pad).
    edges: (m_pad, 2) int32 ranks (lo, hi), lo < hi; padding rows must use the
           sentinel so they contribute zero.
    """
    n_pad, md = nbrs.shape
    sentinel = n_pad
    total = torch.zeros((), dtype=count_dtype(), device=nbrs.device)
    for s in range(0, edges.shape[0], edge_batch):
        e = edges[s:s + edge_batch].to(torch.int64)
        fu = nbrs[e[:, 0].clamp(max=n_pad - 1)]
        fv = nbrs[e[:, 1].clamp(max=n_pad - 1)]
        pos = torch.searchsorted(fv, fu).clamp_(0, md - 1)
        hit = (torch.gather(fv, 1, pos) == fu) & (fu < sentinel)
        total += (hit.sum(dim=1) * (e[:, 0] < sentinel)).sum()
    return total


# --------------------------------------------------------------------------
# Ring (dense row-block streaming) — the dynamic pipeline
# --------------------------------------------------------------------------
# The spec constructors are memoized, as in the reference, so a pipeline's
# per-spec memo (``DynamicPipeline.jit``) sees the same spec for the same
# shape; bounded, since every rows_per_stage is a new key.
@lru_cache(maxsize=64)
def dense_ring_spec(rows_per_stage: int) -> FilterSpec:
    """FilterSpec for the dense ring. Resident = this stage's row block U_s
    (R, n_pad) uint8; streamed blocks are the row blocks of every stage; the
    block from stage k covers ranks [k*R, (k+1)*R) (the k-slice of the
    contraction). Each visit is one masked matmul-sum:
    Σ (U_s[:, kR:(k+1)R] @ U_k) ⊙ U_s."""
    R = rows_per_stage

    def init(u_s):
        return (u_s, torch.zeros((), dtype=count_dtype(), device=u_s.device))

    def process(state, u_k, src):
        u_s, acc = state
        cols = u_s[:, src * R:(src + 1) * R]
        return (u_s, acc + masked_matmul_sum(cols, u_k, u_s))

    def finalize(state):
        return state[1]

    return FilterSpec(init=init, process=process, finalize=finalize)


def build_dense_ring_operands(
    g: Graph, n_stages: int, *, balance: bool = True, pad_to: int = 8, device=None
) -> tuple[RingPartition, torch.Tensor]:
    """Stage row blocks (S, R, n_pad) of the rank-permuted U, uint8, built
    on ``device`` (the 0/1 adjacency at 1 byte per entry)."""
    dev = resolve_device(device)
    part = ring_partition(g, n_stages, balance=balance, pad_to=pad_to)
    n_pad = part.n_pad
    ru = part.rank[g.edges[:, 0]]
    rv = part.rank[g.edges[:, 1]]
    lo = torch.from_numpy(np.minimum(ru, rv).astype(np.int64)).to(dev)
    hi = torch.from_numpy(np.maximum(ru, rv).astype(np.int64)).to(dev)
    u = torch.zeros((n_pad, n_pad), dtype=torch.uint8, device=dev)
    u[lo, hi] = 1
    return part, u.reshape(n_stages, part.rows_per_stage, n_pad)


def _ring_run(spec: FilterSpec, resident, stream, n_stages: int, mesh, sequential: bool):
    """The reference's dispatch: the ring on ``mesh`` when it has more than
    one stage and ``sequential`` is off, else the stage chain."""
    if sequential or mesh is None or mesh.size == 1:
        return run_sequential(spec, resident, stream, n_stages)
    if n_stages != mesh.size:
        raise ValueError(f"n_stages={n_stages} on a mesh of {mesh.size} stages")
    return mesh_runtime(mesh, mesh.axis_names[0]).pipeline.run(spec, resident, stream)


def _ring_setup(mesh, n_stages: int | None, device) -> tuple[int, torch.device]:
    """(stage count, operand device): a mesh's width and stage 0's device
    unless given; a device of another type than the mesh's raises."""
    if mesh is None:
        return n_stages or 1, resolve_device(device)
    dev = mesh.devices[0] if device is None else resolve_device(device)
    if dev.type != mesh.device_type:
        raise ValueError(f"device {dev} is not of the mesh's type {mesh.device_type!r}")
    return n_stages or mesh.size, dev


def count_triangles_ring(g: Graph, *, mesh=None, n_stages: int | None = None,
                         balance: bool = True, sequential: bool = False,
                         device=None) -> int:
    """Distributed dense count. With a ``mesh`` of more than one stage it
    runs :class:`DynamicPipeline`, each stage on its own device and stream;
    with ``sequential=True`` (or no mesh, or a one-stage mesh) the
    paper-faithful stage chain on one device. Operands are built on
    ``device`` (default: the mesh's first stage, else ``cuda``)."""
    n_stages, dev = _ring_setup(mesh, n_stages, device)
    part, blocks = build_dense_ring_operands(g, n_stages, balance=balance, device=dev)
    spec = dense_ring_spec(part.rows_per_stage)
    return int(_ring_run(spec, blocks, blocks, n_stages, mesh, sequential))


# --------------------------------------------------------------------------
# Bitset ring (edge-block streaming) — the literal edge stream
# --------------------------------------------------------------------------
@lru_cache(maxsize=1)
def bitset_ring_spec() -> FilterSpec:
    """Resident = (n_pad, W) int32 membership bitmask over this stage's
    responsible ranks; streamed = (B, 2) int32 edge blocks in rank space.
    Each visit closes the block against the mask table with one bitset
    edge-count kernel launch. The table stays in device memory at every
    size: the reference's VMEM/SMEM budget gate is a TPU limit."""

    def init(mask):
        return (mask, torch.zeros((), dtype=count_dtype(), device=mask.device))

    def process(state, edge_block, src):
        mask, acc = state
        return (mask, acc + bitset_edge_count(mask, edge_block))

    def finalize(state):
        return state[1]

    return FilterSpec(init=init, process=process, finalize=finalize)


def build_bitset_ring_operands(
    g: Graph, n_stages: int, *, balance: bool = True, edge_block: int | None = None,
    pad_to: int = 1, device=None
) -> tuple[RingPartition, torch.Tensor, torch.Tensor]:
    """(partition, masks (S, n_pad, W) int32, edges (S, edge_block, 2) int32).

    masks[s, x, w] bit j is set iff x ∈ fwd_adj(rank s*R + w*32 + j); the
    words are the reference's uint32 masks reinterpreted as int32. They are
    built on ``device``: each set bit is added once into its word, and
    adding distinct powers of two (2³¹ as int32's −2³¹) is a bitwise or.
    Edge blocks are padded with the phantom id n_pad."""
    dev = resolve_device(device)
    part = ring_partition(g, n_stages, balance=balance, pad_to=pad_to)
    R, n_pad = part.rows_per_stage, part.n_pad
    W = -(-R // 32)
    ru = part.rank[g.edges[:, 0]]
    rv = part.rank[g.edges[:, 1]]
    lo = np.minimum(ru, rv)
    hi = np.maximum(ru, rv)
    s = torch.from_numpy((lo // R).astype(np.int64)).to(dev)
    local = torch.from_numpy((lo % R).astype(np.int64)).to(dev)
    hi_t = torch.from_numpy(hi.astype(np.int64)).to(dev)
    bit_ids = torch.unique(((s * n_pad + hi_t) * W + local // 32) * 32 + local % 32)
    bits = torch.ones_like(bit_ids) << (bit_ids % 32)
    bits = torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)
    masks = torch.zeros(n_stages * n_pad * W, dtype=torch.int32, device=dev)
    masks.index_add_(0, bit_ids // 32, bits)
    # edge stream blocks (padded with sentinel n_pad)
    m = len(lo)
    if edge_block is None:
        edge_block = -(-m // n_stages)
    edges = np.full((n_stages * edge_block, 2), n_pad, dtype=np.int32)
    edges[:m, 0] = lo
    edges[:m, 1] = hi
    return (part, masks.reshape(n_stages, n_pad, W),
            torch.from_numpy(edges.reshape(n_stages, edge_block, 2)).to(dev))


def count_triangles_bitset_ring(g: Graph, *, mesh=None, n_stages: int | None = None,
                                balance: bool = True, sequential: bool = False,
                                device=None) -> int:
    """Bitset count with the edge blocks streaming through the stages: on
    ``mesh`` as :func:`count_triangles_ring` says, else the stage chain."""
    n_stages, dev = _ring_setup(mesh, n_stages, device)
    part, masks, edges = build_bitset_ring_operands(g, n_stages, balance=balance,
                                                    device=dev)
    return int(_ring_run(bitset_ring_spec(), masks, edges, n_stages, mesh, sequential))


# --------------------------------------------------------------------------
# Host conveniences
# --------------------------------------------------------------------------
def count_triangles(g: Graph, *, method: str = "dense", **kw) -> int:
    """DEPRECATED front door, a thin shim over ``repro_torch.api``.

    Routes through the shared planner-driven ``TriangleCounter`` (its
    ``count_triangles``; ``device=`` as there, ``cuda`` by default);
    ``method="auto"`` lets the planner choose. New code should use
    ``repro_torch.api.TriangleCounter`` directly."""
    from repro_torch.api import count_triangles as _api_count_triangles

    return _api_count_triangles(g, method=method, **kw)
