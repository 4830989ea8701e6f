"""The plain reference: exact triangle counts of an edge stream, in plain
PyTorch, independent of the program under test (it imports nothing of it).

The stream's semantics, as the configurations state them: the graph is
the simple graph of the records fed, so self-loops count nothing and a
repeated edge, in either orientation, counts once. The count is exact.

The count orients every edge from the lower to the higher (degree, id),
pairs the out-edges of each node into wedges, and looks each wedge's
closing edge up among the sorted edge keys, ``chunk`` wedges at a time.
It runs on whatever device its input lies on.
"""
from __future__ import annotations

import torch


def simple_edges(records: torch.Tensor, n: int) -> torch.Tensor:
    """Sorted unique int64 keys lo·n + hi of the simple graph of
    ``records`` (k, 2): self-loops dropped, duplicates merged."""
    u, v = records[:, 0].to(torch.int64), records[:, 1].to(torch.int64)
    keep = u != v
    lo, hi = torch.minimum(u, v)[keep], torch.maximum(u, v)[keep]
    return torch.unique(lo * n + hi)


def count_keys(keys: torch.Tensor, n: int, chunk: int = 1 << 24) -> int:
    """Triangles of the simple graph whose sorted unique keys lo·n + hi
    are ``keys``."""
    if keys.numel() == 0:
        return 0
    dev = keys.device
    lo, hi = keys // n, keys % n
    deg = torch.bincount(torch.cat([lo, hi]), minlength=n)
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[torch.argsort(deg * n + torch.arange(n, device=dev))] = torch.arange(n, device=dev)
    a, b = rank[lo], rank[hi]
    okeys = torch.sort(torch.minimum(a, b) * n + torch.maximum(a, b)).values
    src, dst = okeys // n, okeys % n
    idx = torch.arange(len(okeys), device=dev)
    row_end = torch.searchsorted(src, src, right=True)
    later = row_end - idx - 1  # out-edges of the same node after this one
    ends = torch.cumsum(later, 0)
    total, first, m = 0, 0, len(okeys)
    while first < m:
        start = int(ends[first] - later[first])
        last = max(int(torch.searchsorted(ends, start + chunk, right=True)), first + 1)
        cnt = later[first:last]
        src_e = torch.repeat_interleave(torch.arange(first, last, device=dev), cnt)
        offs = torch.cumsum(cnt, 0) - cnt
        step = torch.arange(int(cnt.sum()), device=dev) - torch.repeat_interleave(offs, cnt) + 1
        wedge = dst[src_e] * n + dst[src_e + step]
        pos = torch.searchsorted(okeys, wedge).clamp(max=m - 1)
        total += int((okeys[pos] == wedge).sum())
        first = last
    return total


def count_triangles(records: torch.Tensor, n: int) -> tuple[int, int]:
    """(triangles, simple edges) of the records (k, 2) over ``n`` nodes."""
    keys = simple_edges(records, n)
    return count_keys(keys, n), int(keys.numel())
