"""The meshes of the port, held in one process: the dynamic pipeline's
ring, and the named N-D ``("data", "model")`` meshes of the LM steps.

The reference is single-controller: one process holds a ``jax.sharding.Mesh``
and hands it to ``TriangleCounter(mesh=)``. The port keeps that contract with
an in-process mesh: a tuple of torch devices, one per ring stage, on which
``core.dynamic_pipeline`` runs each stage on a CUDA stream of its own.
Several stages may share one device — ``make_ring_mesh(4, devices=[cuda:0]
* 4)`` is a four-stage ring on one card, the counterpart of the reference's
forced host devices — and on a machine with several cards the same code
puts the stages on distinct devices, where the ring's rotation becomes a
peer copy. The CPU is a stage's device only where ``devices`` names it.

:class:`Mesh` is the reference's ``jax.sharding.Mesh`` in the same terms: a
named N-D array of torch devices, one per mesh coordinate, on which the
expert-parallel MoE (``models.moe.moe_apply_ep``) runs each coordinate's
share of the work and ``launch.sharding.place`` puts each coordinate's
shard. ``make_local_mesh(data=2, model=4, devices=[cuda:0] * 8)`` is the
one-card (2, 4) mesh, ``devices=["cpu"] * 8`` the tests' mesh. The
builders mirror ``repro/launch/mesh.py``: ``make_local_mesh``,
``make_production_mesh`` (16 x 16, or 2 x 16 x 16 across two pods),
``data_parallel_axes`` and ``named``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
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


class Mesh:
    """A named N-D mesh of torch devices: coordinate c on ``devices[c]``.

    ``devices`` is an array-like (nested lists or a numpy array) whose
    shape is the mesh's, one entry per axis of ``axis_names``; entries are
    torch devices or their names, all of one device type. Several
    coordinates may share a device. ``shape`` maps each axis name to its
    size in axis order (``mesh.shape["model"]``), as the reference's
    ``Mesh.shape`` does; ``devices`` is a fresh numpy object array in mesh
    order. Hashable and compared by value."""

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        names = tuple(axis_names)
        if arr.ndim != len(names):
            raise ValueError(f"a mesh of {arr.ndim} dims needs as many axis names, got {names}")
        if len(set(names)) != len(names) or not all(isinstance(a, str) for a in names):
            raise ValueError(f"axis names must be distinct strings, got {names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        flat = tuple(_canonical(d) for d in arr.flat)
        if len({d.type for d in flat}) != 1:
            raise ValueError(f"the coordinates of one mesh share a device type, got "
                             f"{sorted({str(d) for d in flat})}")
        self._flat, self._sizes, self.axis_names = flat, tuple(arr.shape), names

    @property
    def devices(self) -> np.ndarray:
        out = np.empty(len(self._flat), dtype=object)
        out[:] = self._flat
        return out.reshape(self._sizes)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self._sizes))

    @property
    def size(self) -> int:
        """The number of coordinates (the reference's ``mesh.devices.size``)."""
        return len(self._flat)

    @property
    def device_type(self) -> str:
        return self._flat[0].type

    def physical_devices(self) -> tuple:
        """The distinct devices under the coordinates, in mesh order."""
        return tuple(dict.fromkeys(self._flat))

    def stages_per_device(self) -> int:
        """The most coordinates any one device hosts (as :class:`RingMesh`'s)."""
        return max(self._flat.count(d) for d in self.physical_devices())

    @property
    def flat_devices(self) -> tuple:
        """The coordinates' devices in mesh order (row-major)."""
        return self._flat

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and (self.axis_names, self.shape, self._flat) == \
            (other.axis_names, other.shape, other.flat_devices)

    def __hash__(self) -> int:
        return hash((self.axis_names, self._sizes, self._flat))

    def __repr__(self) -> str:
        axes = ", ".join(f"{a!r}: {n}" for a, n in self.shape.items())
        return f"Mesh({axes}; {', '.join(str(d) for d in self.physical_devices())})"


def _pool(n: int, devices, what: str) -> list:
    """The first ``n`` of ``devices``, or of the CUDA cards when it is None;
    raises when there are fewer: never wraps coordinates onto one device
    unasked."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        pool = [torch.device("cuda", i) for i in range(count)]
        hint = "; pass devices=[...] to place several coordinates on one device"
    else:
        pool, hint = list(devices), ""
    if n < 1 or n > len(pool):
        raise ValueError(f"{what} needs {n} {'CUDA ' if devices is None else ''}devices, "
                         f"found {len(pool)}{hint}")
    return pool[:n]


def make_local_mesh(*, data: int | None = None, model: int = 1, devices=None) -> Mesh:
    """A ``("data", "model")`` mesh of ``data`` x ``model`` coordinates over
    the first devices of ``devices`` (default: the CUDA cards). ``data``
    defaults to as many rows as the devices fill, as the reference's."""
    if model < 1:
        raise ValueError(f"model={model}: the model axis needs at least one coordinate")
    devices = None if devices is None else list(devices)
    if data is None:
        n = len(devices) if devices is not None else (
            torch.cuda.device_count() if torch.cuda.is_available() else 0)
        data = n // model
    pool = _pool(data * model, devices, f"make_local_mesh(data={data}, model={model})")
    return Mesh(np.array(pool, dtype=object).reshape(data, model), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The target deployment mesh: (16, 16) ``("data", "model")`` = 256
    coordinates a pod, or (2, 16, 16) ``("pod", "data", "model")`` across
    two pods; ``devices`` must hold exactly that many."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    devices = None if devices is None else list(devices)
    if devices is not None and len(devices) != n:
        raise ValueError(f"the production mesh {shape} needs exactly {n} devices, got "
                         f"{len(devices)}")
    pool = _pool(n, devices, f"make_production_mesh(multi_pod={multi_pod})")
    return Mesh(np.array(pool, dtype=object).reshape(shape), axes)


def data_parallel_axes(mesh) -> tuple[str, ...]:
    """Axes that carry batch parallelism (everything except ``"model"``)."""
    return tuple(a for a in mesh.axis_names if a != "model")


def named(mesh, *spec):
    """``NamedSharding(mesh, P(*spec))``."""
    from repro_torch.launch.sharding import NamedSharding, PartitionSpec

    return NamedSharding(mesh, PartitionSpec(*spec))


def data_model_grid(mesh: Mesh) -> np.ndarray:
    """The mesh's devices as a (rows, model) array: row r is the r-th index
    over the data-parallel axes taken together (row-major in mesh order, as
    a spec's ``("pod", "data")`` splits a dim), column m the ``"model"``
    index. Raises ``ValueError`` on a mesh without a ``"model"`` axis."""
    if "model" not in mesh.axis_names:
        raise ValueError(f"the mesh {mesh.axis_names} has no 'model' axis")
    arr = np.moveaxis(mesh.devices, mesh.axis_names.index("model"), -1)
    return arr.reshape(-1, mesh.shape["model"])


def flat_ring(mesh) -> RingMesh:
    """A :class:`RingMesh` over a mesh's coordinates in mesh order (the
    reference's ``_flat_axes``: every axis flattened into one); a
    ``RingMesh`` as it is."""
    return mesh if isinstance(mesh, RingMesh) else RingMesh(mesh.flat_devices)
