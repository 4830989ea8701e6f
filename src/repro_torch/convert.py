"""Carry data and plans across from the reference package.

This system runs no model: its "weights" are the graph and the plan. A
reference ``Graph`` crosses as its numpy arrays (:func:`graph_from_arrays`);
a reference ``Plan`` crosses as its dict, since the port's
:class:`~repro_torch.api.planner.Plan` has the same fields
(``Plan.from_dict(ref_plan.to_dict())``, and back the same way)."""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.formats import Graph


def graph_from_arrays(n_nodes: int, edges) -> Graph:
    """The port's ``Graph`` from a reference graph's arrays: ``edges`` is
    the (m, 2) canonical edge list (u < v, unique rows), copied as int32.
    Raises on a wrong shape or an id outside [0, n_nodes)."""
    e = np.array(edges, dtype=np.int64).reshape(-1, 2)
    if e.size and (e.min() < 0 or e.max() >= n_nodes):
        raise ValueError(f"edge ids must lie in [0, {n_nodes})")
    return Graph(edges=e.astype(np.int32), n_nodes=int(n_nodes))
