"""Launch helpers: the in-process ring mesh of the dynamic pipeline.

``mesh.make_ring_mesh`` builds the 1-D "stage" ring that ``TriangleCounter
(mesh=)``, ``core.dynamic_pipeline`` and the mesh stream ingests run on.
The rest of the reference's ``launch`` (production meshes, sharding, the
dry run) is ROADMAP.md queue A item 6e.
"""
from repro_torch.launch.mesh import RingMesh, make_ring_mesh

__all__ = ["RingMesh", "make_ring_mesh"]
