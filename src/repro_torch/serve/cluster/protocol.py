"""Length-prefixed wire protocol between the session router and workers.

One message = one frame:

    [4B big-endian total payload length]
    [4B big-endian header length][header JSON]
    [array buffers, C-order, concatenated in header manifest order]

The header is a plain JSON dict (op, sid, seq, ...) whose reserved
``"__arrays__"`` key is the manifest ``[[name, dtype, shape], ...]`` for
the binary section — edge blocks and result counts ride as raw buffers,
never through JSON, so a count crosses the wire with its exact dtype and
bits (the cluster tier's bit-identity contract depends on it). The format
is the reference's (``repro.serve.cluster.protocol``) byte for byte, so a
frame written by either package decodes under the other.

This module imports numpy and the standard library only: neither torch
nor the reference package. A torch tensor in a header is turned into
numbers by :func:`jsonable` through its own ``tolist`` method.
"""
from __future__ import annotations

import json
import socket
import struct
import sys

import numpy as np

# One frame must hold a whole checkpoint-sized reply; 1 GiB is far above
# any state this repo plans, and low enough to catch a corrupt length
# prefix before a bad alloc does.
MAX_FRAME_BYTES = 1 << 30


class WorkerDied(ConnectionError):
    """The peer socket closed or broke mid-message — on the router side
    this IS the failure detector: a worker whose connection drops is
    declared dead and its sessions are resurrected elsewhere."""


class ProtocolError(RuntimeError):
    """A frame that cannot be a message (bad length, bad manifest)."""


def _is_tensor(x) -> bool:
    """Whether ``x`` is a torch tensor, told without importing torch: a
    process that never imported it holds none."""
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


def jsonable(x):
    """Recursively coerce ``x`` into JSON-encodable builtins — reply
    headers carry stats dicts that mix python, numpy and torch numbers. A
    torch tensor (a count on the card, a scalar) becomes its numbers,
    copied to the host, never its ``repr``."""
    if isinstance(x, dict):
        return {str(k): jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [jsonable(v) for v in x]
    if isinstance(x, (np.bool_, bool)):
        return bool(x)
    if isinstance(x, (np.integer, int)):
        return int(x)
    if isinstance(x, (np.floating, float)):
        return float(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    if _is_tensor(x):
        return jsonable(x.tolist())
    if x is None or isinstance(x, str):
        return x
    return str(x)


def send_msg(sock: socket.socket, header: dict,
             arrays: dict | None = None) -> None:
    """Send one frame: ``header`` (JSON dict) plus named numpy arrays."""
    manifest, buffers = [], []
    for name, arr in (arrays or {}).items():
        a = np.ascontiguousarray(arr)
        manifest.append([name, a.dtype.str, list(a.shape)])
        buffers.append(a.tobytes())
    head = json.dumps({**jsonable(header), "__arrays__": manifest},
                      separators=(",", ":")).encode()
    payload = b"".join([struct.pack(">I", len(head)), head, *buffers])
    try:
        sock.sendall(struct.pack(">I", len(payload)) + payload)
    except OSError as e:
        raise WorkerDied(f"send failed: {e}") from None


def recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise :class:`WorkerDied` on EOF/reset."""
    chunks, got = [], 0
    while got < n:
        try:
            chunk = sock.recv(min(n - got, 1 << 20))
        except OSError as e:
            raise WorkerDied(f"recv failed: {e}") from None
        if not chunk:
            raise WorkerDied("connection closed mid-message")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_msg(sock: socket.socket) -> tuple[dict, dict]:
    """Receive one frame; returns ``(header, arrays)`` with the manifest
    key stripped from the header and each buffer rebuilt as a writable
    numpy array."""
    (total,) = struct.unpack(">I", recv_exact(sock, 4))
    if total > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame of {total} B exceeds "
                            f"{MAX_FRAME_BYTES} B — corrupt length prefix?")
    payload = recv_exact(sock, total)
    (hlen,) = struct.unpack(">I", payload[:4])
    if hlen > total - 4:
        raise ProtocolError(f"header length {hlen} overruns {total} B frame")
    header = json.loads(payload[4:4 + hlen].decode())
    manifest = header.pop("__arrays__", [])
    arrays, off = {}, 4 + hlen
    for name, dtype, shape in manifest:
        dt = np.dtype(dtype)
        nbytes = dt.itemsize * int(np.prod(shape, dtype=np.int64))
        if off + nbytes > total:
            raise ProtocolError(f"array {name!r} overruns the frame")
        arrays[name] = np.frombuffer(
            payload, dtype=dt, count=nbytes // dt.itemsize,
            offset=off).reshape(shape).copy()
        off += nbytes
    return header, arrays


def raise_remote(header: dict):
    """Re-raise a worker-side failure (``{"ok": False, "etype", "error"}``)
    as the matching local exception type — budget refusals must cross the
    wire as ``BackpressureError`` so the router's placement logic can
    catch exactly what it would catch in-process."""
    from repro_torch.api.planner import BackpressureError

    etype = header.get("etype", "RuntimeError")
    msg = header.get("error", "worker error")
    mapped = {
        "BackpressureError": BackpressureError,
        "ValueError": ValueError,
        "KeyError": KeyError,
        "RuntimeError": RuntimeError,
        "TypeError": TypeError,
    }.get(etype)
    if mapped is not None:
        raise mapped(msg)
    raise RuntimeError(f"{etype}: {msg}")
