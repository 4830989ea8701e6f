"""Launch helpers: the in-process ring mesh of the dynamic pipeline, and
the training driver.

``mesh.make_ring_mesh`` builds the 1-D "stage" ring that ``TriangleCounter
(mesh=)``, ``core.dynamic_pipeline``, the mesh stream ingests and
``models.ring_attention`` run on; ``train.train_lm`` (``python -m
repro_torch.launch.train``) trains an LM with checkpoints and exact
restart. The rest of the reference's ``launch`` (the ``("data", "model")``
production meshes, sharding, the dry run) is ROADMAP.md queue A item 6e.
"""
from repro_torch.launch.mesh import RingMesh, make_ring_mesh

__all__ = ["RingMesh", "make_ring_mesh"]
