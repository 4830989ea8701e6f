#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the chips of this machine.

    python3 bench/run.py --workload ny_road.streams8 --seed 7 --seconds 30 --trace 0

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: the numbers compared, each with its
limit. The same numbers are the last lines of standard error. Exits
non-zero, printing no result, without enough CUDA devices, or when a JAX
module or the JAX package has been loaded once the window has closed.

Every cache the program builds stays inside this checkout, at fixed paths:
the port's kernel libraries under ``build/repro_torch_kernels``, and the
caches named below under ``build/``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch

    from bench import harness

    cell, _, _ = harness.cell_files(ROOT, harness.load_spec(ROOT), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); this machine has "
              f"{have}", file=sys.stderr)
        return 2

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                           t_start=T_START, log=log)
    bad = harness.forbidden_modules()
    if bad:
        log(f"forbidden modules loaded in the measuring process: {', '.join(bad)}")
        return 3
    print(json.dumps(out), flush=True)
    for line in harness.check_lines(out["checks"]):
        log(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
