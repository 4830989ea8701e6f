"""Streaming state sizes (the ingest itself is a later item of the port).

Only :func:`hybrid_state_nbytes` is here so far: the planner's sizing of the
degree-aware hybrid stream state needs it."""
from __future__ import annotations

from repro_torch.utils import count_dtype


def hybrid_state_nbytes(n_nodes: int, hub_slots: int, tail_capacity: int) -> int:
    """EXACT device bytes of the hybrid streaming state — ``hub_slots``
    full bitset rows (H, W) int32 plus their owner ids (H,), per-vertex hub
    slots (n,), ``tail_capacity`` neighbor slots per vertex (n, C) and
    degrees (n,), all int32, then the running count (``count_dtype()``, int64
    here) and the int32 ``lost`` counter — the formula the planner charges
    at admission."""
    w = -(-n_nodes // 32)
    scalar = count_dtype().itemsize
    return 4 * (hub_slots * w + hub_slots + n_nodes * (tail_capacity + 2)) \
        + scalar + 4
