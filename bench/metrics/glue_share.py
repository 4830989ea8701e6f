"""Share of the device time of the window's trace spent in rows that are
neither the program's own kernels nor copies (fills, sorts, scatters and
gathers, elementwise and reduce kernels, memsets), in percent."""
import re


def read(ctx):
    if ctx.trace is None:
        return None
    own = re.compile(r"\b(" + "|".join(map(re.escape, ctx.port_kernels)) + r")\b") \
        if ctx.port_kernels else None
    total = glue = 0.0
    for name, (secs, _) in ctx.trace.by_name().items():
        total += secs
        if "memcpy" not in name.lower() and not (own and own.search(name)):
            glue += secs
    return 100.0 * glue / total if total > 0 else None
