"""Cluster worker process: one ``StreamMultiplexer`` behind a socket.

Run as a module::

    python -m repro_torch.serve.cluster.worker --memory-bytes N \\
        [--devices K] [--device cuda|cuda:I|cpu] [--port P] [--max-stages S] \\
        [--block-size B] [--prefetch-depth D]

The process binds a localhost TCP port, prints ``WORKER_READY <port>`` on
stdout (the spawn handshake :class:`~repro_torch.serve.cluster.client.
WorkerClient` waits for), accepts ONE router connection, and serves
length-prefixed requests until the router sends ``shutdown`` or the
connection drops.

``--device`` is where the multiplexer's counter runs: ``cuda`` (the
default) or ``cpu``. Without a card a ``cuda`` worker raises; it never
falls back to the host. ``--memory-bytes`` is this worker's share of its
device, and its multiplexer charges the card's reserve — the CUDA context
of this process among it — inside that share; several workers on one card
are given shares that sum to at most the card's free memory when they
start. The worker never reads the card's whole memory as its budget.

``--devices K`` (> 1) builds a :class:`~repro_torch.launch.RingMesh` of K
stages. ``cuda`` takes K cards (``make_ring_mesh(K)``, which raises with
fewer); a device with an index (``cuda:0``) or ``cpu`` puts every stage on
that one device, and says so through ``make_ring_mesh(K, devices=...)``.
``hello`` advertises the ring width whose per-stage discount the mesh
really gives (``mesh_devices``): K where each stage has a device of its
own, 0 where stages share one, so the router's
``api.worker_admission`` re-takes every ring plan at width 1 there, as
this worker's multiplexer does (``api.planner.mesh_admission``).

Ops (request ``{"op": ...}`` → reply ``{"ok": True, ...}``; failures
reply ``{"ok": False, "etype", "error"}`` and the worker keeps serving):

- ``hello``                        → advertised budget/mesh/pid
- ``open``/``feed``/``advance``    → multiplexer lifecycle; ``feed`` and
  ``advance`` carry a router ``seq`` and are EXACTLY-ONCE: a seq at or
  below the session's high-water mark is acknowledged without re-applying,
  so the router may blindly replay its journal after a failover
- ``checkpoint {sid, path}``       → non-destructive compressed spill of a
  live session (the router's durability barrier)
- ``evict {sid, path}``            → checkpoint + forget (migration send)
- ``restore {path, seq}``          → adopt a spilled checkpoint (the
  port's or the reference's) as a new session (migration receive /
  failover resurrect)
- ``close``                        → finalize; the count is copied to the
  host and returns as a raw int64 buffer, so its bits survive the wire
  (a session cancelled while queued replies with ``plan`` null)
- ``status`` / ``stats`` / ``ping`` / ``shutdown``; ``stats`` also carries
  this process's kernel launch counters (``launches``)
"""
from __future__ import annotations

import argparse
import os
import socket
import sys

from repro_torch.serve.cluster import protocol


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port", type=int, default=0,
                    help="TCP port to bind (0 = ephemeral, printed on stdout)")
    ap.add_argument("--memory-bytes", type=int, required=True,
                    help="this worker's share of its device: the budget its "
                         "multiplexer admits against, the card's reserve included")
    ap.add_argument("--devices", type=int, default=1,
                    help="ring stages (>1 builds a ring mesh)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; K cards for --devices K), cuda:I (every "
                         "stage on card I) or cpu")
    ap.add_argument("--max-stages", type=int, default=None,
                    help="planner ring-width cap (default: --devices)")
    ap.add_argument("--block-size", type=int, default=0,
                    help="uniform default ingest block size (0 = planner's)")
    ap.add_argument("--prefetch-depth", type=int, default=0,
                    help="async prefetch pipeline depth per session "
                         "(0 = synchronous drive loop)")
    return ap.parse_args(argv)


def _build_mux(args):
    """(multiplexer, its Resources, advertised mesh width) for ``args``."""
    import torch

    from repro_torch.api import Resources, TriangleCounter
    from repro_torch.launch import make_ring_mesh
    from repro_torch.serve.sessions import StreamMultiplexer
    from repro_torch.utils import resolve_device

    dev = resolve_device(args.device)
    mesh = None
    if args.devices > 1:
        if dev.type == "cuda" and dev.index is None:
            mesh = make_ring_mesh(args.devices)
        else:
            mesh = make_ring_mesh(args.devices, devices=[dev] * args.devices)
        dev = mesh.devices[0]
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)  # this process's kernels launch on that card
    res = Resources(memory_bytes=args.memory_bytes, n_devices=args.devices,
                    backend=dev.type,
                    max_stages=(args.max_stages if args.max_stages is not None
                                else args.devices))
    counter = TriangleCounter(res, device=dev, mesh=mesh)
    mux = StreamMultiplexer(counter, block_size=args.block_size or None,
                            prefetch_depth=args.prefetch_depth or None)
    return mux, res, advertised_mesh_devices(mesh)


def advertised_mesh_devices(mesh) -> int:
    """The ``mesh_devices`` a worker holding ``mesh`` advertises in
    ``hello``: the ring width where every stage has a device of its own,
    the only layout whose per-stage discount is real, and 0 where stages
    share a device (or there is no mesh), so the router's
    ``worker_admission`` re-takes every ring plan at width 1 — verdict for
    verdict what ``mesh_admission`` decides on this mesh."""
    return mesh.size if mesh is not None and mesh.stages_per_device() == 1 else 0


def _handle(op, header, arrays, mux, res, mesh_devices, last_seq):
    """Execute one request; returns ``(reply_header, reply_arrays, stop)``."""
    import numpy as np

    from repro_torch.core import streaming

    if op == "hello":
        return ({"ok": True, "pid": os.getpid(),
                 "memory_bytes": res.memory_bytes,
                 "n_devices": res.n_devices, "backend": res.backend,
                 "max_stages": res.max_stages,
                 "mesh_devices": mesh_devices,
                 "block_size": mux.block_size}, None, False)
    if op == "ping":
        return ({"ok": True}, None, False)
    if op == "shutdown":
        return ({"ok": True}, None, True)
    if op == "open":
        sid = mux.open(int(header["n_nodes"]),
                       block_size=header.get("block_size"),
                       window=header.get("window"),
                       priority=int(header.get("priority") or 0))
        return ({"ok": True, "sid": sid, "status": mux.status(sid),
                 "state_bytes": mux.state_bytes_of(sid)}, None, False)
    if op in ("feed", "advance"):
        sid, seq = int(header["sid"]), header.get("seq")
        if seq is not None and seq <= last_seq.get(sid, -1):
            # replayed journal entry the pre-failover worker already
            # applied: acknowledge, don't double-count
            return ({"ok": True, "dedup": True}, None, False)
        if op == "feed":
            mux.feed(sid, arrays["edges"])
        else:
            mux.advance(sid)
        if seq is not None:
            last_seq[sid] = seq
        return ({"ok": True}, None, False)
    if op == "checkpoint":
        ckpt = mux.checkpoint(int(header["sid"]))
        raw = ckpt.nbytes
        ckpt.spill(header["path"])
        return ({"ok": True, "nbytes": raw, "disk_bytes": ckpt.disk_bytes},
                None, False)
    if op == "evict":
        sid = int(header["sid"])
        ckpt = mux.evict(sid)
        last_seq.pop(sid, None)
        raw = ckpt.nbytes
        ckpt.spill(header["path"])
        return ({"ok": True, "nbytes": raw, "disk_bytes": ckpt.disk_bytes,
                 "state_bytes": ckpt.state_bytes}, None, False)
    if op == "restore":
        from repro_torch.api import SessionCheckpoint

        ckpt = SessionCheckpoint.from_file(header["path"])
        sid = mux.adopt(ckpt, priority=int(header.get("priority") or 0))
        if header.get("seq") is not None:
            last_seq[sid] = int(header["seq"])
        return ({"ok": True, "sid": sid,
                 "state_bytes": mux.state_bytes_of(sid)}, None, False)
    if op == "close":
        sid = int(header["sid"])
        result = mux.close(sid)
        last_seq.pop(sid, None)
        # the count may live on the card: copy it to the host first
        count = result.count.cpu().numpy().astype(np.int64)
        plan = result.plan.to_dict() if result.plan is not None else None  # cancelled
        return ({"ok": True, "plan": plan,
                 "wall_s": result.wall_s,
                 "stats": protocol.jsonable(result.stats)},
                {"count": count}, False)
    if op == "status":
        return ({"ok": True, "status": mux.status(int(header["sid"]))},
                None, False)
    if op == "stats":
        from repro_torch.kernels import launch_counts

        return ({"ok": True, "bytes_in_use": mux.bytes_in_use,
                 "n_active": mux.n_active, "n_queued": mux.n_queued,
                 "n_preempted": mux.n_preempted,
                 "ingest_traces": streaming.ingest_trace_count(),
                 "sched": protocol.jsonable(mux.sched_stats),
                 "launches": launch_counts()}, None, False)
    raise ValueError(f"unknown op {op!r}")


def serve(conn, mux, res, mesh_devices) -> None:
    """Request loop over one router connection (returns on shutdown or on
    the router going away — a worker never outlives its router)."""
    last_seq: dict[int, int] = {}  # sid -> exactly-once high-water mark
    while True:
        try:
            header, arrays = protocol.recv_msg(conn)
        except protocol.WorkerDied:
            return
        try:
            reply, out, stop = _handle(header.get("op"), header, arrays,
                                       mux, res, mesh_devices, last_seq)
        except Exception as e:  # noqa: BLE001 — every failure crosses the wire
            protocol.send_msg(conn, {"ok": False, "etype": type(e).__name__,
                                     "error": str(e)})
            continue
        protocol.send_msg(conn, reply, out)
        if stop:
            return


def main(argv=None) -> int:
    args = _parse(argv)
    mux, res, mesh_devices = _build_mux(args)
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", args.port))
    srv.listen(1)
    print(f"WORKER_READY {srv.getsockname()[1]}", flush=True)
    conn, _ = srv.accept()
    try:
        serve(conn, mux, res, mesh_devices)
    finally:
        conn.close()
        srv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
