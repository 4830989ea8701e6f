"""Launch helpers: the in-process meshes, the sharding rules, and the
training driver.

``mesh.make_ring_mesh`` builds the 1-D "stage" ring that ``TriangleCounter
(mesh=)``, ``core.dynamic_pipeline``, the mesh stream ingests and
``models.ring_attention`` run on; ``mesh.make_local_mesh`` /
``make_production_mesh`` build the named ``("data", "model")`` meshes of the
expert-parallel MoE and the LM mesh steps; ``sharding`` holds the
reference's spec trees and places tensors on a mesh; ``train.train_lm``
(``python -m repro_torch.launch.train``) trains an LM with checkpoints and
exact restart; ``dryrun`` (``python -m repro_torch.launch.dryrun``) builds
every (architecture, shape) cell on the production mesh of meta
coordinates and records its memory and roofline a device, at the H100's
rates of ``hlo_analysis``, beside ``analytic``'s closed forms (ROADMAP.md
item 6f).
"""
from repro_torch.launch.mesh import (
    Mesh,
    RingMesh,
    data_model_grid,
    data_parallel_axes,
    flat_ring,
    make_local_mesh,
    make_production_mesh,
    make_ring_mesh,
    named,
)
from repro_torch.launch.sharding import (
    NamedSharding,
    P,
    PartitionSpec,
    Placed,
    check_specs,
    dp_axes,
    gather,
    gnn_batch_specs,
    gnn_param_specs,
    lm_batch_specs,
    lm_cache_specs,
    lm_param_specs,
    opt_state_specs,
    place,
    recsys_batch_specs,
    recsys_param_specs,
    shardings_from_specs,
)

__all__ = [
    "Mesh", "RingMesh", "data_model_grid", "data_parallel_axes", "flat_ring",
    "make_local_mesh", "make_production_mesh", "make_ring_mesh", "named",
    "NamedSharding", "P", "PartitionSpec", "Placed", "check_specs", "dp_axes", "gather",
    "gnn_batch_specs", "gnn_param_specs", "lm_batch_specs", "lm_cache_specs",
    "lm_param_specs", "opt_state_specs", "place", "recsys_batch_specs",
    "recsys_param_specs", "shardings_from_specs",
]
