"""Share of the window the host spent inside the server's ``open_stream``,
``feed`` and ``close_stream`` (the benchmark's own spans around them), in
percent. The rest is the wait for counts and the benchmark's own work."""


def read(ctx):
    inside = sum(e - s for label, s, e in ctx.spans if label in ("open", "feed", "close"))
    return 100.0 * inside / ctx.window_s
