"""Router-side handle to one worker process: spawn, RPC, liveness.

``WorkerClient.spawn`` launches ``python -m repro_torch.serve.cluster.worker``
as a subprocess, waits for its ``WORKER_READY <port>`` handshake, connects
one TCP socket, and performs the ``hello`` exchange that caches the
worker's advertised :class:`~repro_torch.api.Resources`, mesh width and
default block size — the inputs to the router's
:class:`~repro_torch.api.WorkerLoad` model. The worker's stderr goes to a
log file (``log_path``), so a worker that dies before it is ready leaves
its traceback, and the error raised here quotes its end.

Every RPC failure at the SOCKET level (reset, EOF, broken pipe) marks the
client dead and raises :class:`~repro_torch.serve.cluster.protocol.
WorkerDied`; application-level failures arrive as ``{"ok": False}``
replies and re-raise as the original exception type
(``BackpressureError`` stays a ``BackpressureError`` across the wire).
"""
from __future__ import annotations

import os
import socket as socket_mod
import subprocess
import sys
import tempfile
import time

from repro_torch.serve.cluster import protocol


def _tail(path: str, n_bytes: int = 4000) -> str:
    """The last ``n_bytes`` of the text file at ``path`` ("" if unreadable)."""
    try:
        with open(path, "rb") as f:
            f.seek(max(os.path.getsize(path) - n_bytes, 0))
            return f.read().decode(errors="replace")
    except OSError:
        return ""


class WorkerClient:
    """One live worker: ``proc`` (subprocess), ``sock`` (its one RPC
    connection), and the budget/mesh facts it advertised at ``hello``."""

    def __init__(self, proc, sock, hello: dict, log_path: str | None = None):
        from repro_torch.api import Resources

        self.proc = proc
        self.sock = sock
        self.pid = hello["pid"]
        self.resources = Resources(
            memory_bytes=hello["memory_bytes"],
            n_devices=hello["n_devices"], backend=hello["backend"],
            max_stages=hello["max_stages"])
        self.mesh_devices = int(hello["mesh_devices"])
        self.block_size = hello.get("block_size")
        self.log_path = log_path
        self._alive = True

    @classmethod
    def spawn(cls, *, memory_bytes: int, devices: int = 1, device: str = "cuda",
              max_stages: int | None = None, block_size: int | None = None,
              prefetch_depth: int | None = None, log_dir: str | None = None,
              startup_timeout_s: float = 180.0) -> "WorkerClient":
        """Start a worker subprocess on ``device`` (``cuda`` unless
        ``device="cpu"``) with ``memory_bytes`` as its share, and complete
        the spawn handshake.

        The child gets ``PYTHONPATH`` pointing at this package's source
        root, so spawning works from a test or bench process no matter what
        the caller's cwd is. Its stderr goes to a ``worker-*.log`` file in
        ``log_dir`` (the system's temporary directory by default)."""
        import repro_torch

        src_root = os.path.dirname(os.path.dirname(
            os.path.abspath(repro_torch.__file__)))
        env = dict(os.environ)
        env["PYTHONPATH"] = src_root + os.pathsep + env.get("PYTHONPATH", "")
        cmd = [sys.executable, "-u", "-m", "repro_torch.serve.cluster.worker",
               "--port", "0", "--memory-bytes", str(int(memory_bytes)),
               "--devices", str(int(devices)), "--device", str(device)]
        if max_stages is not None:
            cmd += ["--max-stages", str(int(max_stages))]
        if block_size is not None:
            cmd += ["--block-size", str(int(block_size))]
        if prefetch_depth is not None:
            cmd += ["--prefetch-depth", str(int(prefetch_depth))]
        with tempfile.NamedTemporaryFile(
                mode="w", dir=log_dir, prefix="worker-", suffix=".log",
                delete=False) as log:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=log,
                                    env=env, text=True)
        deadline = time.monotonic() + startup_timeout_s
        port = None
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                if proc.poll() is not None:
                    proc.stdout.close()
                    raise protocol.WorkerDied(
                        f"worker exited with {proc.returncode} before READY; "
                        f"the end of its log {log.name}:\n{_tail(log.name)}")
                continue
            if line.startswith("WORKER_READY"):
                port = int(line.split()[1])
                break
        if port is None:
            proc.kill()
            proc.wait(timeout=30)
            proc.stdout.close()
            raise protocol.WorkerDied(
                f"worker not READY within {startup_timeout_s:.0f}s; the end "
                f"of its log {log.name}:\n{_tail(log.name)}")
        sock = socket_mod.create_connection(("127.0.0.1", port), timeout=None)
        sock.setsockopt(socket_mod.IPPROTO_TCP, socket_mod.TCP_NODELAY, 1)
        client = cls.__new__(cls)
        client.proc, client.sock, client._alive = proc, sock, True
        try:
            hello, _ = client.rpc({"op": "hello"})
        except protocol.WorkerDied as e:
            client.kill()
            raise protocol.WorkerDied(f"{e}; the end of its log {log.name}:\n"
                                      f"{_tail(log.name)}") from None
        client.__init__(proc, sock, hello, log_path=log.name)
        return client

    @property
    def alive(self) -> bool:
        return self._alive and (self.proc is None or self.proc.poll() is None)

    def rpc(self, header: dict, arrays: dict | None = None) -> tuple:
        """One request/reply exchange; returns ``(reply_header, arrays)``.
        Socket failure ⇒ client marked dead + :class:`WorkerDied`; a
        ``{"ok": False}`` reply re-raises the worker-side exception."""
        if not self._alive:
            raise protocol.WorkerDied(
                f"worker pid {getattr(self, 'pid', '?')} already dead")
        try:
            protocol.send_msg(self.sock, header, arrays)
            reply, out = protocol.recv_msg(self.sock)
        except protocol.WorkerDied as e:
            self._alive = False
            raise protocol.WorkerDied(
                f"worker pid {getattr(self, 'pid', '?')} lost during "
                f"{header.get('op')!r}: {e}") from None
        if not reply.get("ok", False):
            protocol.raise_remote(reply)
        return reply, out

    def shutdown(self) -> None:
        """Graceful stop: ask, then reap (kill if asking failed). The log
        of a worker that stopped when asked is removed; a killed or lost
        worker's stays."""
        try:
            self.rpc({"op": "shutdown"})
        except protocol.WorkerDied:
            self.kill()
            return
        self.kill()
        if self.log_path is not None and os.path.exists(self.log_path):
            os.remove(self.log_path)

    def kill(self) -> None:
        """Hard stop: close the socket, kill and reap the subprocess."""
        self._alive = False
        try:
            self.sock.close()
        except OSError:
            pass
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
        if self.proc is not None:
            self.proc.wait(timeout=30)
            if self.proc.stdout is not None:
                self.proc.stdout.close()
