"""GNNs of the port: on one device the message-passing substrate
(``common``), GIN, GraphCast, DimeNet, the CG tables (``cg``) and MACE,
module for module the reference's ``repro/models/gnn``, and the partitioned
losses of ``distributed.py``: node rows split over the stages of a
``launch.RingMesh`` (ROADMAP.md queue A item 6c-ii)."""
