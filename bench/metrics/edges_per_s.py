"""Edge records fed to sessions that returned a checked exact count, over
the whole window (its start to the last close's count on the host)."""


def read(ctx):
    good = sum(r.fed for r in ctx.sessions if r.count is not None and r.count == r.expected)
    return good / ctx.window_s
