"""The dynamic pipeline's ring mesh, held in one process.

The reference is single-controller: one process holds a ``jax.sharding.Mesh``
and hands it to ``TriangleCounter(mesh=)``. The port keeps that contract with
an in-process mesh: a tuple of torch devices, one per ring stage, on which
``core.dynamic_pipeline`` runs each stage on a CUDA stream of its own.
Several stages may share one device — ``make_ring_mesh(4, devices=[cuda:0]
* 4)`` is a four-stage ring on one card, the counterpart of the reference's
forced host devices — and on a machine with several cards the same code
puts the stages on distinct devices, where the ring's rotation becomes a
peer copy. The CPU is a stage's device only where ``devices`` names it.
"""
from __future__ import annotations

import dataclasses

import torch


def _canonical(device) -> torch.device:
    """``device`` as a torch device with an explicit index on CUDA (``cuda``
    is ``cuda:0``), so equal stages compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", 0)
    return dev


@dataclasses.dataclass(frozen=True)
class RingMesh:
    """A 1-D ring of pipeline stages, stage s on ``devices[s]``.

    ``axis_names`` is ``("stage",)`` and ``shape`` is ``{"stage": S}``, so
    code reads like the reference's ``mesh.axis_names[0]`` and
    ``mesh.shape[ax]``. Hashable: the mesh ingests are memoized on it."""

    devices: tuple
    axis_names: tuple = ("stage",)

    def __post_init__(self):
        devs = tuple(_canonical(d) for d in self.devices)
        if not devs:
            raise ValueError("a ring mesh needs at least one stage")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"the stages of one mesh share a device type, got "
                             f"{[str(d) for d in devs]}")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))

    @property
    def size(self) -> int:
        """The ring width S (the reference's ``mesh.devices.size``)."""
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: self.size}

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    def physical_devices(self) -> tuple:
        """The distinct devices under the stages, in stage order: one for
        a ring of S stages on one card, S on S cards."""
        return tuple(dict.fromkeys(self.devices))

    def stages_per_device(self) -> int:
        """The most stages any one device hosts: 1 when every stage has a
        device of its own, S when all share one. A session's per-stage
        shards add up on a shared device, so this is the factor its charge
        takes there."""
        return max(self.devices.count(d) for d in self.physical_devices())


def make_ring_mesh(n_stages: int | None = None, *, devices=None) -> RingMesh:
    """1-D ring mesh for the dynamic-pipeline runtime ("stage" axis).

    Without ``devices`` it takes the first ``n_stages`` CUDA devices (all of
    them when ``n_stages`` is None) and raises when there are fewer: it
    never wraps several stages onto one device unasked. ``devices`` places
    the stages explicitly — ``[torch.device("cuda", 0)] * 4`` asks for four
    stages on one card, ``["cpu"] * 4`` four on the host — and
    ``n_stages``, if given, must equal its length."""
    if devices is not None:
        devices = list(devices)
        if n_stages is not None and n_stages != len(devices):
            raise ValueError(f"n_stages={n_stages} but {len(devices)} devices given")
        return RingMesh(tuple(devices))
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_stages is None:
        n_stages = count
    if n_stages < 1 or n_stages > count:
        raise ValueError(
            f"make_ring_mesh({n_stages}) needs {n_stages} CUDA devices, found "
            f"{count}; pass devices=[...] to place several stages on one device")
    return RingMesh(tuple(torch.device("cuda", i) for i in range(n_stages)))
