"""The dynamic-pipeline runtime: a chain of stages, or a ring on a mesh.

The paper's dynamic pipeline is a chain of stateful filters through which
the input *streams*; each filter consumes what it is responsible for and
forwards the rest. A :class:`FilterSpec` is one such filter lifted to a
stage over a rank partition. Two runtimes execute it, and every stage sees
every block exactly once in both:

- :func:`run_sequential` visits the stages in chain order on one device, a
  Python loop over stages × blocks.
- :class:`DynamicPipeline` runs the ring on a ``launch.mesh.RingMesh``: each
  stage specializes on its resident block on its own device and CUDA
  stream, and the streamed blocks rotate around the ring
  (:func:`ring_stream`), the move of the next block issued before the
  current one is consumed.

:class:`ShardedStateStream` reuses the stage axis to shard a stream
consumer's STATE: each stage owns one shard and every streamed block is
broadcast to all of them (``core.streaming.make_mesh_ingest``).

One process drives the whole mesh (the reference is single-controller too),
so a cross-stage sum cannot run inside a stage function as the reference's
``psum`` does; the runtimes run in phases with events between the stages'
streams instead. Every run opens with each stage's stream waiting on the
caller's current stream and closes with the caller's stream waiting on the
stages, so a tensor one side allocated and the other read is reused by the
caching allocator only after that read. The same code runs a ring of one
card's streams, of several cards (where a rotation is a peer copy), and of
the CPU (where streams and events are absent and every phase runs in
order).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
from typing import Any, Callable

import torch

from repro_torch.utils import tree_map


@dataclasses.dataclass(frozen=True)
class FilterSpec:
    """A dynamic-pipeline filter, lifted to a stage over a rank partition.

    init(resident)                      -> state       (filter specialization)
    process(state, block, src_stage)    -> state       (consume one streamed block)
    finalize(state)                     -> partial      (the filter's output)

    ``partial`` is summed over the stages — the paper's aggregation phase
    where partial counts flow down the pipe to a collector.
    """

    init: Callable[[Any], Any]
    process: Callable[[Any, Any, int], Any]
    finalize: Callable[[Any], Any]


def _stage(tree, s: int):
    """Stage s's slice of every leaf of ``tree`` (leading axis n_stages)."""
    return tree_map(lambda x: x[s], tree)


def run_sequential(spec: FilterSpec, resident, stream, n_stages: int):
    """Paper-faithful single-process pipeline: stages visited in chain order.

    ``resident`` and ``stream`` are tensors, or trees of tensors (dicts,
    lists, tuples), whose leaves have leading axis ``n_stages``: stage s
    specializes on ``resident``'s slice s and consumes ``stream``'s slice t
    for every t, tagged with its source stage t. Returns the sum of the
    stages' partials, leaf by leaf (device tensors — no host sync)."""
    total = None
    for s in range(n_stages):
        state = spec.init(_stage(resident, s))
        for t in range(n_stages):
            state = spec.process(state, _stage(stream, t), t)
        part = spec.finalize(state)
        total = part if total is None else tree_map(torch.add, total, part)
    return total


# The reference keeps an eager loop beside its compiled scan-of-scans as the
# differential oracle; in eager PyTorch both are this one loop.
run_sequential_python = run_sequential


class StageStreams:
    """One CUDA stream per stage of a mesh, and the events between them.

    On a CPU mesh there are no streams: every method is then a no-op and
    the phases run in program order."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.streams = tuple(torch.cuda.Stream(device=d) if d.type == "cuda" else None
                             for d in mesh.devices)

    def on(self, s: int):
        """Context in which stage s's work is issued on its stream."""
        st = self.streams[s]
        return contextlib.nullcontext() if st is None else torch.cuda.stream(st)

    def record(self, s: int):
        """An event after the work issued so far on stage s's stream."""
        st = self.streams[s]
        if st is None:
            return None
        ev = torch.cuda.Event()
        ev.record(st)
        return ev

    def wait(self, s: int, *events) -> None:
        """Stage s's stream waits on ``events`` (Nones are skipped)."""
        st = self.streams[s]
        for ev in events:
            if ev is not None:
                st.wait_event(ev)

    def begin(self) -> list:
        """Every stage's stream waits on the caller's current stream of its
        device: what the caller issued before (operands, uploads) is ready.
        Returns those caller streams (Nones on the CPU)."""
        callers = []
        for s, dev in enumerate(self.mesh.devices):
            caller = None
            if self.streams[s] is not None:
                caller = torch.cuda.current_stream(dev)
                ev = torch.cuda.Event()
                ev.record(caller)
                self.streams[s].wait_event(ev)
            callers.append(caller)
        return callers

    def scratch(self, s: int, caller, held: list, shape) -> torch.Tensor:
        """An uninitialized int32 tensor on stage s's device for work on
        stage s's stream, allocated from the pool of the caller's stream
        ``caller``. The caching allocator keeps one pool per stream, and a
        pool's free memory serves only that stream: gigabytes of scratch
        taken from the stages' pools would sit there idle while the
        caller's allocations run out. ``held`` keeps the tensor until the
        run's end, after which the caller's stream waits on the stages."""
        with contextlib.nullcontext() if caller is None else torch.cuda.stream(caller):
            t = torch.empty(shape, dtype=torch.int32, device=self.mesh.devices[s])
        held.append(t)
        return t

    def end(self, events) -> None:
        """The caller's current stream of each stage's device waits on that
        stage's event in ``events``."""
        for dev, ev in zip(self.mesh.devices, events):
            if ev is not None:
                torch.cuda.current_stream(dev).wait_event(ev)

    def send(self, x, s: int, d: int):
        """``x`` (a tensor on stage s's device, or a tree of them) on stage
        d's device, issued on stage s's stream: a peer copy between two
        cards, the same tensor when the two stages share one (the blocks are
        read-only). The receiving stage waits on an event its sender records
        after this."""
        dev = self.mesh.devices[d]
        with self.on(s), self.on(d):
            return tree_map(lambda t: t.to(dev, non_blocking=True), x)


def ring_stream(process: Callable[[Any, Any, int], Any], carries: list, blocks: list,
                *, mesh, streams: StageStreams) -> list:
    """Rotate the stages' blocks around the ring, folding each visit into
    the visited stage's carry; returns the carries.

    Single-controller, unlike the reference's SPMD ``ring_stream`` (which
    each device runs inside ``shard_map`` on its own block): one process
    holds every stage's carry and block (``carries[s]`` and ``blocks[s]`` on
    stage s's device) and issues S steps for all stages. At each step stage
    s first issues the move of its current block to stage s+1 — the
    reference's double buffering, the ``ppermute`` of the next block issued
    before ``process`` consumes this one — then calls ``process(carry,
    block, src)`` on its own stream, ``src`` being the stage the block
    originated from. The receiving stage waits on an event the sender
    recorded after the move; the first blocks must be ready on their own
    stages' streams."""
    n = mesh.size
    held, src, arrived = list(blocks), list(range(n)), [None] * n
    for step in range(n):
        nxt, nxt_arrived = [None] * n, [None] * n
        for s in range(n):
            with streams.on(s):
                streams.wait(s, arrived[s])
                if step + 1 < n:  # the last visit forwards nothing
                    d = (s + 1) % n
                    nxt[d] = streams.send(held[s], s, d)
                    nxt_arrived[d] = streams.record(s)
                carries[s] = process(carries[s], held[s], src[s])
        held, arrived = nxt, nxt_arrived
        src = [src[(s - 1) % n] for s in range(n)]
    return carries


def _check_axis(mesh, axis_name: str) -> int:
    if axis_name not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis_name!r}")
    return mesh.shape[axis_name]


# Each runtime remembers at most this many specs, oldest dropped first: the
# spec constructors in ``triangle_pipeline`` are memoized, so their specs
# recur, while a hand-built spec is a new key on every call.
_SPEC_MEMO = 64


class DynamicPipeline:
    """Execute a :class:`FilterSpec` over a 1-D ring mesh.

    resident: tensor, or tree of tensors, with leading axis n_stages —
              stage-local state source (the filter's adjacency partition);
              slice s of every leaf goes to stage s's device.
    stream:   tensor, or tree of tensors, with leading axis n_stages — the
              blocks that flow through every stage (the edge stream).

    ``run`` returns the sum of the stages' partials, leaf by leaf, on stage
    0's device, issued on the caller's current stream after it waited on
    every stage.
    """

    def __init__(self, mesh, axis_name: str = "stage", streams: StageStreams | None = None):
        self.n_stages = _check_axis(mesh, axis_name)
        self.mesh = mesh
        self.axis_name = axis_name
        self.streams = streams or StageStreams(mesh)
        self._memo: collections.OrderedDict = collections.OrderedDict()

    def run(self, spec: FilterSpec, resident, stream):
        st, devs = self.streams, self.mesh.devices
        st.begin()
        carries, blocks = [], []
        for s in range(self.n_stages):
            with st.on(s):
                put = lambda x, dev=devs[s]: x.to(dev, non_blocking=True)  # noqa: E731
                carries.append(spec.init(tree_map(put, _stage(resident, s))))
                blocks.append(tree_map(put, _stage(stream, s)))
        carries = ring_stream(spec.process, carries, blocks, mesh=self.mesh, streams=st)
        partials, done = [], []
        for s in range(self.n_stages):
            with st.on(s):
                partials.append(spec.finalize(carries[s]))
                done.append(st.record(s))
        st.end(done)
        total = partials[0]
        for p in partials[1:]:
            total = tree_map(lambda a, b: a + b.to(devs[0], non_blocking=True), total, p)
        return total

    def jit(self, spec: FilterSpec) -> Callable:
        """``run`` bound to ``spec``, memoized per spec like the reference's
        compiled ring, so the counter's cache entries share one callable.
        Eager PyTorch compiles nothing; the memo keeps the reference's
        contract (and stays bounded)."""
        fn = self._memo.get(spec)
        if fn is None:
            fn = self._memo[spec] = lambda resident, stream: self.run(spec, resident, stream)
            if len(self._memo) > _SPEC_MEMO:
                self._memo.popitem(last=False)
        else:
            self._memo.move_to_end(spec)
        return fn


class ShardedStateStream:
    """Persistent sharded-state stream fold: the pipeline's stage axis reused
    to shard a stream consumer's STATE instead of its input.

    Each stage owns one shard of the state on its device and its stream;
    every streamed block is broadcast to all stages, which fold it into
    their shards concurrently. One process drives the stages, so a step
    runs in phases (:meth:`step`) with the cross-stage sums between them.
    Used by ``core.streaming`` for the column-sharded adjacency bitset
    (n²/8/S bytes per stage)."""

    def __init__(self, mesh, axis_name: str = "stage", streams: StageStreams | None = None):
        self.n_stages = _check_axis(mesh, axis_name)
        self.mesh = mesh
        self.axis_name = axis_name
        self.streams = streams or StageStreams(mesh)

    @classmethod
    def shared(cls, mesh, axis_name: str = "stage") -> "ShardedStateStream":
        """The mesh's one sharded-state runtime (:func:`mesh_runtime`)."""
        return mesh_runtime(mesh, axis_name).sharded

    def _psum(self, parts: list) -> torch.Tensor:
        """Σ of the per-stage ``parts`` on stage 0's device, issued on stage
        0's stream (the caller has made it wait on every stage)."""
        total = parts[0]
        for s in range(1, len(parts)):
            total = total + self.streams.send(parts[s], s, 0)
        return total

    def step(self, shards: list, block: torch.Tensor, *, canonical, seen, update,
             combine) -> None:
        """Fold one block into the sharded state, in the reference step's
        phases:

        0. stage 0: ``keep, *shared = canonical(block)`` (the block lies on
           stage 0's device; ``shared`` — the block's canonical endpoints,
           say — goes to every stage);
        1. every stage s: ``seen_s, ctx_s = seen(s, shards[s], scratch_s,
           *shared)`` on its shard;
        2. stage 0: ``live = keep & (Σ_s seen_s == 0)``, the cross-stage sum;
        3. every stage s: ``terms_s = update(s, shards[s], scratch_s, ctx_s,
           live, *shared)``, which updates the shard in place;
        4. stage 0: the cross-stage sum of the terms;
        5. stage 0: ``combine(terms)`` once.

        ``scratch_s(shape)`` is an uninitialized int32 tensor for stage s's
        large temporaries (:meth:`StageStreams.scratch`). Stage 0's results
        reach the other stages on their devices after an event of stage 0,
        and theirs reach stage 0 after an event of each. The caller's
        streams wait on stage 0 at the end."""
        st, n = self.streams, self.n_stages
        callers, held = st.begin(), []
        scratch = [functools.partial(st.scratch, s, callers[s], held) for s in range(n)]
        with st.on(0):
            keep, *shared = canonical(block)
        ev0 = st.record(0)
        local, seen_parts, ctx, evs = [], [], [], []
        for s in range(n):
            with st.on(s):
                st.wait(s, ev0)
                local.append([st.send(x, 0, s) for x in shared])
                part, c = seen(s, shards[s], scratch[s], *local[s])
                seen_parts.append(part)
                ctx.append(c)
            evs.append(st.record(s))
        with st.on(0):
            st.wait(0, *evs)
            live = keep & (self._psum(seen_parts) == 0)
        ev0 = st.record(0)
        terms, evs = [], []
        for s in range(n):
            with st.on(s):
                st.wait(s, ev0)
                terms.append(update(s, shards[s], scratch[s], ctx[s], st.send(live, 0, s),
                                    *local[s]))
            evs.append(st.record(s))
        with st.on(0):
            st.wait(0, *evs)
            combine(self._psum(terms))
        st.end([st.record(0)] * n)


class MeshRuntime(collections.namedtuple("MeshRuntime", "pipeline sharded")):
    """The ring and the sharded-state runtime of one (mesh, axis), on one set
    of stage streams."""


@functools.lru_cache(maxsize=32)
def mesh_runtime(mesh, axis_name: str) -> MeshRuntime:
    """The runtimes of ``mesh``, made once per (mesh, axis): every consumer
    on one mesh — the ring counts, the counter's cache entries, each stream
    session's mesh ingest — issues its stages' work on the same streams.
    Both runtimes open each run with the stages waiting on the caller and
    close it with the caller waiting on them, so they share the streams
    safely."""
    streams = StageStreams(mesh)
    return MeshRuntime(DynamicPipeline(mesh, axis_name, streams),
                       ShardedStateStream(mesh, axis_name, streams))
