"""Mean time from a ``close_stream`` call to the session's count on the
host (the tail block flushed, the device caught up, the count copied),
over every session closed in the window: the total of those spans over
their number, so that the total, not one close, is what the host's clock
reads."""


def read(ctx):
    closes = sum(1 for label, _, _ in ctx.spans if label == "close")
    if not closes:
        return None
    total = sum(e - s for label, s, e in ctx.spans if label in ("close", "count"))
    return 1e3 * total / closes
