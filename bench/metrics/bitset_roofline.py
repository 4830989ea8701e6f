"""Share of their memory roofline that the bitset closures reach, in percent.

Numerator: the least time the closures could take at the HBM rate, from the
bytes they need, reckoned from the workload whatever implements them: each
distinct edge a bitset session ingested is closed once against its two
pre-block rows of the layout's row width (``peaks.closure_bytes`` over those
edges). Denominator: the device time of the kernels that
``bitset_roofline.json`` beside this file names. The program's own choices
(padded blocks, the in-block terms, rows read more than once) count in the
time only, so the share falls where they cost.
"""
import json
from pathlib import Path

from bench.peaks import HBM_BW, closure_bytes, row_words


def read(ctx):
    if ctx.trace is None:
        return None
    names = json.loads((Path(__file__).with_suffix(".json")).read_text())["kernels"]
    edges = sum(r.simple_edges for r in ctx.sessions
                if r.stats.get("layout") == "bitset" and r.simple_edges)
    secs = sum(acc[0] for name, acc in ctx.trace.by_name().items()
               if any(k in name for k in names))
    if not edges or secs <= 0:
        return None
    need = closure_bytes(edges, edges, row_words(ctx.n_nodes))
    return 100.0 * need / HBM_BW / secs
