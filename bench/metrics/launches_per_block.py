"""Device kernel rows of the window's trace over the blocks its sessions
ingested (``stats["n_blocks"]``, summed)."""
from bench.devtrace import is_copy


def read(ctx):
    blocks = sum(r.stats.get("n_blocks", 0) for r in ctx.sessions)
    if ctx.trace is None or not blocks:
        return None
    rows = sum(acc[1] for name, acc in ctx.trace.by_name().items() if not is_copy(name))
    return rows / blocks
