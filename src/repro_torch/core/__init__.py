"""The paper's primary contribution: dynamic-pipeline triangle counting.

- ``dynamic_pipeline``: the stage-chain runtime (one device) and the ring
  on a mesh (``DynamicPipeline``, ``ShardedStateStream``)
- ``partition``: responsible-node ordering + stage load balancing
- ``triangle_ref``: oracles
- ``triangle_mapreduce``: Suri–Vassilvitskii two-round baseline (faithful)
- ``triangle_pipeline``: the dynamic-pipeline counting algorithm (dense /
  sparse / ring / bitset-ring paths)
"""

from repro_torch.core.triangle_ref import count_triangles_brute, count_triangles_dense_ref
from repro_torch.core.triangle_pipeline import (
    count_triangles_dense,
    count_triangles_sparse,
    count_triangles_ring,
    count_triangles_bitset_ring,
)
from repro_torch.core.triangle_mapreduce import count_triangles_mapreduce

__all__ = [
    "count_triangles_brute",
    "count_triangles_dense_ref",
    "count_triangles_dense",
    "count_triangles_sparse",
    "count_triangles_ring",
    "count_triangles_bitset_ring",
    "count_triangles_mapreduce",
]
