"""GNNs of the port on one device: the message-passing substrate
(``common``), GIN, GraphCast, DimeNet, the CG tables (``cg``) and MACE,
module for module the reference's ``repro/models/gnn``. The partitioned
losses of ``distributed.py`` are still to come (ROADMAP.md queue A item
6c-ii)."""
