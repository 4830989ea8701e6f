"""The dry run's roofline terms and collective traffic on the NVIDIA H100,
the port of ``repro/launch/hlo_analysis.py``.

The reference compiles each cell with XLA and parses the compiled HLO: its
cost analysis gives FLOPs and bytes accessed, and every all-gather,
all-reduce, reduce-scatter, all-to-all and collective-permute in the module
text gives its operand and wire bytes. The port compiles nothing, so there
is no HLO to parse. In its place the dry run (``launch.dryrun``) counts
FLOPs with ``torch.utils.flop_counter.FlopCounterMode`` over one step and
bytes accessed with a dispatch mode, and reckons the collectives of the
port's program from the cell's spec trees and shapes
(:func:`roofline_from_counts` takes the three).

Each collective is charged by the reference's own per-kind rule
(``repro/launch/hlo_analysis.py:93-107``), from its per-device RESULT bytes
r and its group size g (:data:`RULES`):

- all-reduce: operand r, wire 2·r·(g−1)/g. The port's program performs
  two: the gradient's sum over the data-parallel axes in a train cell, and
  the expert-parallel MoE's sum of the model shards' parts over
  ``"model"`` (``models.moe.moe_apply_ep``) in an MoE cell on a mesh;
- all-gather: operand r/g, wire (r/g)·(g−1): ``replicate_rows``, the
  gather of the node shards in the partitioned GNN;
- collective-permute: operand and wire r: each step of the triangle
  ring's rotation (``core.dynamic_pipeline.ring_stream``).

The port's program performs no reduce-scatter and no all-to-all, so their
rules are not carried over.

GSPMD's tensor-parallel collectives for the dense weights sharded on
``"model"`` are not reckoned: the port's single controller performs none
(ROADMAP.md §C).

The hardware constants are the H100 SXM5's, from NVIDIA's data sheet
(dense tensor-core rates), for the card ``nvidia-smi`` prints as "NVIDIA
H100 80GB HBM3, 700.00 W".
"""
from __future__ import annotations

import dataclasses

import torch

PEAK_FLOPS = 989.4e12  # bf16 tensor cores, dense, FLOP/s
HBM_BW = 3.35e12  # device memory, bytes/s
LINK_BW = 450e9  # NVLink 4, bytes/s in one direction (900 GB/s both ways)
# the data sheet's other rates, which chip_smoke.py's kernel bounds read
PEAK_INT8_OPS = 1.979e15  # int8 tensor cores, dense, op/s
PEAK_TF32_FLOPS = 494.7e12  # TF32 tensor cores, dense
PEAK_F32_FLOPS = 66.9e12  # FP32 on the CUDA cores

_DTYPE_BYTES = {
    torch.bool: 1, torch.uint8: 1, torch.int8: 1, torch.int16: 2, torch.bfloat16: 2,
    torch.float16: 2, torch.int32: 4, torch.float32: 4, torch.int64: 8, torch.float64: 8,
    torch.complex64: 8, torch.complex128: 16,
}


def _all_gather(r: int, g: int) -> tuple[float, float]:
    op = r // max(g, 1)
    return op, op * (g - 1)


def _all_reduce(r: int, g: int) -> tuple[float, float]:
    return r, 2.0 * r * (g - 1) / max(g, 1)


def _collective_permute(r: int, g: int) -> tuple[float, float]:
    return r, r


# kind -> (per-device result bytes, group size) -> (operand bytes, wire bytes)
RULES = {"all-gather": _all_gather, "all-reduce": _all_reduce,
         "collective-permute": _collective_permute}


def dtype_bytes(dtype: torch.dtype) -> int:
    return _DTYPE_BYTES[dtype]


def peak_ops(dtype: torch.dtype) -> float:
    """The dense tensor-core rate a cell's operations are charged at, by
    its operands' dtype: int8's for 8-bit integer operands (the triangle
    ring's uint8 blocks), else bf16's: as the reference charges every cell
    at one peak, the f32 parts of a cell are not told apart."""
    return PEAK_INT8_OPS if dtype in (torch.int8, torch.uint8) else PEAK_FLOPS


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    operand_bytes: dict  # per collective kind, summed over ops (per device)
    wire_bytes: dict  # modeled bytes crossing links per device (ring algos)

    @property
    def total_operand_bytes(self) -> int:
        return sum(self.operand_bytes.values())

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())


def collective_stats(ops) -> CollectiveStats:
    """The stats of ``ops``, an iterable of ``(kind, result_bytes, group,
    count)``: ``count`` collectives of one kind, each with that per-device
    result and group, charged by :data:`RULES`."""
    counts = {k: 0 for k in RULES}
    operand = {k: 0 for k in RULES}
    wire = {k: 0.0 for k in RULES}
    for kind, result_bytes, group, count in ops:
        if not count:
            continue
        op_b, wire_b = RULES[kind](int(result_bytes), int(group))
        counts[kind] += count
        operand[kind] += op_b * count
        wire[kind] += wire_b * count
    return CollectiveStats(counts=counts, operand_bytes=operand, wire_bytes=wire)


@dataclasses.dataclass
class Roofline:
    """Byte and FLOP fields are PER DEVICE, as the reference's: the global
    counts of one step over ``n_devices`` (kept beside them as
    ``global_flops`` and ``global_bytes_accessed``); collective bytes are
    per device as reckoned. compute = global FLOPs / (devices · peak), at
    ``peak_flops`` (:func:`peak_ops` of the cell's operands)."""

    flops: float
    bytes_accessed: float
    collective_operand_bytes: float
    collective_wire_bytes: float
    n_devices: int
    global_flops: float = 0.0
    global_bytes_accessed: float = 0.0
    peak_flops: float = PEAK_FLOPS

    @property
    def compute_s(self) -> float:
        return self.flops / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def collective_s(self) -> float:
        # wire bytes are per-device-modeled; each device drives its own links
        return self.collective_wire_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "collective_operand_bytes": self.collective_operand_bytes,
            "collective_wire_bytes": self.collective_wire_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "n_devices": self.n_devices,
            "global_flops": self.global_flops,
            "global_bytes_accessed": self.global_bytes_accessed,
            "peak_flops": self.peak_flops,
        }


def roofline_from_counts(flops: float, bytes_accessed: float, collectives: CollectiveStats,
                         n_devices: int, peak_flops: float = PEAK_FLOPS) -> Roofline:
    """The roofline of one step from its GLOBAL FLOPs and bytes accessed
    (the dry run's counts) and its per-device collectives, its compute
    charged at ``peak_flops``."""
    return Roofline(
        flops=flops / n_devices,
        bytes_accessed=bytes_accessed / n_devices,
        collective_operand_bytes=float(collectives.total_operand_bytes),
        collective_wire_bytes=float(collectives.total_wire_bytes),
        n_devices=n_devices,
        global_flops=float(flops),
        global_bytes_accessed=float(bytes_accessed),
        peak_flops=peak_flops,
    )
