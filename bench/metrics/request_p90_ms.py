"""90th percentile, over every session that streamed its whole graph, of
the time from its ``open_stream`` call to its count on the host: the
highest percentile with ten or more of a window's sessions beyond it."""
import statistics


def read(ctx):
    lat = [(r.t_done - r.t_open) * 1e3 for r in ctx.sessions if r.full and r.count is not None]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=10)[8]
