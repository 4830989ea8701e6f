"""The dynamic-pipeline runtime, on one device.

The paper's dynamic pipeline is a chain of stateful filters through which
the input *streams*; each filter consumes what it is responsible for and
forwards the rest. A :class:`FilterSpec` is one such filter lifted to a
stage over a rank partition; :func:`run_sequential` visits the stages in
chain order and streams every block through each, so every stage sees every
block exactly once — the ring's semantics without the ring.

On one card this is a Python loop over stages × blocks with one kernel
launch per visit (``spec.process``); partial counts stay on the device and
are added there. The multi-device ring (``DynamicPipeline``, ``ring_stream``,
``ShardedStateStream`` over ``torch.distributed``) is a later item of the
port (ROADMAP.md, queue A).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable


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


def run_sequential(spec: FilterSpec, resident, stream, n_stages: int):
    """Paper-faithful single-process pipeline: stages visited in chain order.

    ``resident`` and ``stream`` are tensors with leading axis ``n_stages``:
    stage s specializes on ``resident[s]`` and consumes ``stream[t]`` for
    every t, tagged with its source stage t. Returns the sum of the stages'
    partials (a device tensor — no host sync)."""
    total = None
    for s in range(n_stages):
        state = spec.init(resident[s])
        for t in range(n_stages):
            state = spec.process(state, stream[t], t)
        part = spec.finalize(state)
        total = part if total is None else total + part
    return total


# The reference keeps an eager loop beside its compiled scan-of-scans as the
# differential oracle; in eager PyTorch both are this one loop.
run_sequential_python = run_sequential
