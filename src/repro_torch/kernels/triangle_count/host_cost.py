"""Host cost of K2's entry point on the card: the host microseconds one
``masked_matmul_sum`` call takes to issue, and the walls of two K2-heavy
rings, so two trees can be compared in one process each.

- per call: ``CALLS`` calls on a small ring visit (A (256, 256), B and M
  (256, 2,048), 0/1 uint8), whose kernel is far shorter than its issue, so
  the loop is host-bound: microseconds a call to issue, and to finish
  (synchronised at the end). Beside the entry point, where the tree has
  them, the custom op called directly (``torch.ops.repro_torch.
  masked_matmul_sum``) and the CUDA implementation called directly;
- the dense ring (``core.triangle_pipeline.dense_ring_spec`` on
  ``DynamicPipeline`` over a one-card ``RingMesh``) and the stage chain
  (``run_sequential``) at S stages of an n-node U (density 0.3, seed 0):
  S² K2 launches each, median of ``REPS`` synchronised walls; with the
  CUDA implementation put in the entry point's place too, where the tree
  has it.

Run it with the tree to measure first on the path; it prints one JSON line:

  PYTHONPATH=<tree>/src python src/repro_torch/kernels/triangle_count/host_cost.py
"""
from __future__ import annotations

import json
import statistics
import time

import torch

CALLS = 2000
REPS = 5
RINGS = ((8, 8192), (32, 8192))  # (stages, n): 64 visits of 1,024 rows, 1,024 of 256


def _per_call(fn, a, b, m) -> dict:
    for _ in range(50):
        fn(a, b, m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn(a, b, m)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"issue_us": (t1 - t0) / CALLS * 1e6, "wall_us": (t2 - t0) / CALLS * 1e6}


def _wall_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def main() -> None:
    from repro_torch.core import triangle_pipeline as tp
    from repro_torch.core.dynamic_pipeline import DynamicPipeline, run_sequential
    from repro_torch.kernels.triangle_count import ops
    from repro_torch.launch import make_ring_mesh

    gen = torch.Generator(device="cuda").manual_seed(0)

    def u01(*shape):
        return (torch.rand(shape, generator=gen, device="cuda") < 0.5).to(torch.uint8)

    a, b, m = u01(256, 256), u01(256, 2048), u01(256, 2048)
    variants = {"entry": ops.masked_matmul_sum}
    try:
        op = torch.ops.repro_torch.masked_matmul_sum
        variants["op"] = lambda a, b, m: op(a, b, m, False)
    except AttributeError:  # a tree without the custom op
        pass
    impl = getattr(ops, "_masked_matmul_sum_cuda", None)
    if impl is not None:
        variants["impl"] = lambda a, b, m, upper_triangular=False: impl(a, b, m,
                                                                          upper_triangular)
    out = {"card": torch.cuda.get_device_name(0), "torch": torch.__version__,
           "per_call": {k: _per_call(fn, a, b, m) for k, fn in variants.items()}, "rings": {}}
    for s_n, n in RINGS:
        u = (torch.rand((n, n), generator=gen, device="cuda") < 0.3).triu(1).to(torch.uint8)
        blocks = u.reshape(s_n, n // s_n, n)
        spec = tp.dense_ring_spec(n // s_n)
        pipe = DynamicPipeline(make_ring_mesh(s_n, devices=["cuda"] * s_n), "stage")
        rec = {}
        for name in ("entry", "impl"):
            if name not in variants:
                continue
            tp.masked_matmul_sum = variants[name]  # what dense_ring_spec's visit calls
            rec[name] = {"ring_ms": _wall_ms(lambda: pipe.run(spec, blocks, blocks)),
                         "chain_ms": _wall_ms(lambda: run_sequential(spec, blocks, blocks, s_n))}
        tp.masked_matmul_sum = ops.masked_matmul_sum
        out["rings"][f"S{s_n}_n{n}"] = rec
        del u, blocks
    print(json.dumps(out))


if __name__ == "__main__":
    main()
