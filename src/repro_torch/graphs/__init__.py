from repro_torch.graphs.formats import (
    Graph,
    canonical_edges,
    degree_order,
    dense_adjacency,
    forward_adjacency_dense,
    forward_adjacency_padded,
    to_csr,
)
from repro_torch.graphs.generators import fixed_arcs, gnp, powerlaw, road_grid

__all__ = [
    "Graph",
    "canonical_edges",
    "degree_order",
    "dense_adjacency",
    "forward_adjacency_dense",
    "forward_adjacency_padded",
    "to_csr",
    "gnp",
    "fixed_arcs",
    "powerlaw",
    "road_grid",
]
