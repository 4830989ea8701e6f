"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. Sources live in ``*/csrc/*.cu`` and are built by ``_build``; no
module here imports or compiles anything CUDA until a kernel is called."""
from __future__ import annotations


def kernels() -> dict:
    """Kernel name -> its :class:`~repro_torch.kernels._build.CudaKernel`."""
    from repro_torch.kernels.bitset_count import ops as bs
    from repro_torch.kernels.triangle_count import ops as tc

    return {"triangle_count_live": tc.LIVE, "masked_matmul_sum": tc.MASKED,
            "bitset_edge_count": bs.EDGE}


def launch_counts() -> dict[str, int]:
    """Kernel name -> launches so far in this process."""
    return {name: k.launches for name, k in kernels().items()}


def reset_launch_counts() -> None:
    for k in kernels().values():
        k.launches = 0
