"""The yardstick's hardware table and byte counts, frozen here so that a
change to the program cannot move them.

Rate: NVIDIA's data sheet for the H100 SXM5 (the 700 W part), as
``repro_torch.launch.hlo_analysis`` states it. Only what a metric reads is
kept: a later metric that needs a compute peak brings it from the same sheet.
"""
from __future__ import annotations

HBM_BW = 3.35e12  # device memory, bytes/s


def closure_bytes(edge_rows: int, real_edges: int, row_words: int) -> int:
    """Bytes one bitset closure (K3, K4 or K5) needs, as ``chip_smoke.py``
    bounds them: its (B, 2) int32 edge block once, both ``row_words``-word
    rows of every real (not phantom) edge, and its 8-byte count."""
    return edge_rows * 2 * 4 + real_edges * 2 * row_words * 4 + 8


def row_words(n_nodes: int) -> int:
    """32-bit words in one row of the bitset layout over ``n_nodes``."""
    return -(-n_nodes // 32)
