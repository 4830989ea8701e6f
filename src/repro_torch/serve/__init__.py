"""Serving loops: the LM server and the triangle-counting server.

``serve_loop`` holds the batched request servers (``LMServer``,
``TriangleServer``); ``sessions`` holds the concurrent multi-stream
machinery — ``StreamMultiplexer`` (the preemptible fair-share scheduler
over ``api.StreamSession``) and ``CheckpointStore`` (its bounded host/disk
parking lot for preempted sessions' checkpoints); ``cluster`` holds the
multi-process tier (``ClusterRouter``, ``WorkerClient``, the worker
process and their wire protocol) that ``serve_loop.ClusterServer`` fronts.
"""
from repro_torch.serve.serve_loop import LMServer, ServeConfig, TriangleServeConfig, TriangleServer
from repro_torch.serve.sessions import CheckpointStore, StreamMultiplexer

__all__ = ["CheckpointStore", "LMServer", "ServeConfig", "StreamMultiplexer",
           "TriangleServeConfig", "TriangleServer"]
