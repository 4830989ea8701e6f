"""Build and bind the port's CUDA kernels: nvcc → shared library → ctypes.

Every ``csrc/*.cu`` under ``repro_torch/kernels/`` compiles on first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``build/repro_torch_kernels/`` at the repository root. The library's
file name carries a hash of its source and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. :func:`build_all` starts one
``nvcc`` per source, all at once. A failed build raises: nothing falls back.

Each C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing, and returns ``cudaGetLastError()``;
:class:`CudaKernel` raises when that is not 0 and counts the launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def sources() -> dict[str, Path]:
    """Library name (the source's stem) -> ``.cu`` path, for every kernel."""
    return {p.stem: p for p in sorted(_KERNELS_DIR.glob("*/csrc/*.cu"))}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    src = sources()[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=None, *, verbose: bool = False) -> dict[str, str]:
    """Compile every (or every named) kernel library that is not built yet,
    one ``nvcc`` process per source, all started together. Returns name ->
    compiler log (``-Xptxas -v`` register/shared-memory report when
    ``verbose``; empty for libraries that were already built)."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(srcs[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{logs[name]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all([name])
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib


class CudaKernel:
    """One C entry point of a kernel library, bound on first call.

    ``launches`` counts the launches that returned without error — the
    evidence that a run went through the kernel. Every pointer argument and
    the stream are ``c_void_p``; the C function returns ``cudaGetLastError()``.
    """

    def __init__(self, library: str, symbol: str, argtypes, error_symbol: str):
        self.library = library
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]  # + stream
        self.error_symbol = error_symbol
        self.launches = 0
        self._fn = None
        self._err = None

    def _bind(self):
        lib = load(self.library)
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, self.error_symbol)
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._err = fn, err
        return fn

    def __call__(self, *args, stream: int) -> None:
        fn = self._fn or self._bind()
        rc = fn(*args, stream)
        if rc != 0:
            msg = self._err(rc).decode(errors="replace")
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error {rc} ({msg})")
        self.launches += 1
