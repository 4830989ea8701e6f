"""Mean device state a session pinned (``stats["state_bytes"]`` of its
result, the planner's predicted bytes), in GiB."""


def read(ctx):
    vals = [r.stats["state_bytes"] for r in ctx.sessions if "state_bytes" in r.stats]
    return sum(vals) / len(vals) / 2**30 if vals else None
