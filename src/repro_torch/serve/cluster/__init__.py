"""Multi-host serving tier: router + worker processes over one wire format.

The paper's pipeline wins exactly when the graph does not fit one
processor's memory; this package lifts the serving stack past one
process's memory the same way. A :class:`ClusterRouter` places incoming
stream sessions across worker PROCESSES by planner-predicted state bytes
(``repro_torch.api.place_session`` — least-loaded-by-bytes, never-fits
rejection at the front door), each worker running the ordinary
:class:`~repro_torch.serve.sessions.StreamMultiplexer` behind a
length-prefixed socket protocol (:mod:`.protocol`, the reference's frames
byte for byte). The bit-identical ``SessionCheckpoint`` is the migration
primitive: the router moves a live session between workers by
checkpoint/evict on one and restore on the other (exact counts, no new
ingest keys on a warm target), and resurrects a dead worker's sessions
from their spilled ``.npz`` checkpoints plus a replay journal.

Workers run on ``cuda`` unless spawned with ``device="cpu"``. Several
workers may share one card: each is given its share of the card's memory
(``memory_bytes``), and each worker's multiplexer charges the card's
reserve, its own CUDA context among it, inside that share — so the shares
must sum to at most the card's free memory when the workers start. The
router's placement charges the same reserve (``api.worker_admission``).
"""
from repro_torch.serve.cluster.client import WorkerClient
from repro_torch.serve.cluster.protocol import WorkerDied, recv_msg, send_msg
from repro_torch.serve.cluster.router import ClusterRouter

__all__ = [
    "ClusterRouter",
    "WorkerClient",
    "WorkerDied",
    "recv_msg",
    "send_msg",
]
