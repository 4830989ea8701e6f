"""Closed-loop streaming clients, the driver of a traffic mix that names
``"driver": "closed_loop"`` and gives:

- ``clients``: C clients, each keeping one stream open. A client opens a
  session, feeds it one whole graph as ragged feeds, closes it, turns the
  count into a host integer, and opens its next session at once.
- ``feed_edges``: [lo, hi], each feed's size in edge records, drawn
  uniformly (the last of a template's sizes takes what is left).

Set-up makes 2·C session templates (an edge order and the feed sizes that
cut it); sessions take them in turn, cycling. The clients share one host
thread and take turns, one call each: the serving front end the
program's multiplexer is built for (one calling thread, many sessions). At
the deadline the clients stop feeding and every open session is closed;
its count covers the edges fed so far.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from bench.session import Session, Spans


@dataclasses.dataclass
class Template:
    """One session's edge order and the offsets that cut it into feeds."""

    records: np.ndarray  # (m, 2) int32, this session's order
    cuts: np.ndarray  # int64 offsets 0 = c0 < c1 < ... = m

    @property
    def n_feeds(self) -> int:
        return len(self.cuts) - 1


def prepare(records: np.ndarray, mix: dict, seed: int) -> list[Template]:
    """2·C templates of ``records``. Template j's feed sizes, in their
    order, are the same at every seed (drawn from j alone), so that a seed
    changes which edges a feed carries and not how the work is cut; the
    seed draws each template's edge order."""
    rng = np.random.default_rng([seed, 1])
    lo, hi = (int(x) for x in mix["feed_edges"])
    m = len(records)
    out = []
    for j in range(2 * int(mix["clients"])):
        sizes = np.random.default_rng([j, 2]).integers(lo, hi + 1, size=m // lo + 1)
        k = int(np.searchsorted(np.cumsum(sizes), m)) + 1
        sizes = sizes[:k].copy()
        sizes[-1] = m - sizes[:-1].sum()
        out.append(Template(records=records[rng.permutation(m)],
                            cuts=np.concatenate([[0], np.cumsum(sizes)])))
    return out


def warm(system, n_nodes: int, templates: list[Template], mix: dict) -> None:
    """Open as many sessions as the mix keeps open, feed each its first two
    feeds, close them and read their counts: every kernel loaded, the
    states' memory mapped, each shape of the window used once."""
    sids = [system.open(n_nodes) for _ in range(int(mix["clients"]))]
    for i, sid in enumerate(sids):
        tpl = templates[i % len(templates)]
        for f in range(min(2, tpl.n_feeds)):
            system.feed(sid, tpl.records[tpl.cuts[f]:tpl.cuts[f + 1]])
    for sid in sids:
        system.count(system.close(sid))


def drive(system, n_nodes: int, templates: list[Template], mix: dict,
          seconds: float) -> tuple[list[Session], Spans, float, float]:
    """Run the closed loop for ``seconds`` and close what is open.
    Returns (sessions, spans, window start, window end): the window ends
    when the last close has returned its count to the host."""
    clients = int(mix["clients"])
    sessions: list[Session] = []
    spans = Spans()
    active: list[tuple[Session, Template] | None] = [None] * clients
    turn = 0

    def start(c: int) -> None:
        nonlocal turn
        j = turn % len(templates)
        turn += 1
        rec = Session(t_open=time.perf_counter())
        sessions.append(rec)
        try:
            rec.sid = spans.call("open", system.open, n_nodes)
        except system.Refused as err:
            rec.error = f"open refused: {err}"
            rec.t_done = time.perf_counter()
            return
        active[c] = (rec, templates[j])

    def finish(c: int) -> None:
        rec, tpl = active[c]
        active[c] = None
        rec.records = tpl.records[:rec.fed]
        # every whole session was fed the same graph
        rec.key = "whole" if rec.full else (id(tpl), rec.fed)
        try:
            result = spans.call("close", system.close, rec.sid)
            rec.count = spans.call("count", system.count, result)
            rec.stats = system.stats(result)
        except system.Failed as err:
            rec.error = f"close failed: {err}"
        rec.t_done = time.perf_counter()

    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        for c in range(clients):
            if time.perf_counter() >= deadline:
                break
            if active[c] is None:
                start(c)
                continue
            rec, tpl = active[c]
            lo, hi = tpl.cuts[rec.feeds], tpl.cuts[rec.feeds + 1]
            spans.call("feed", system.feed, rec.sid, tpl.records[lo:hi])
            rec.feeds += 1
            rec.fed = int(hi)
            if rec.feeds == tpl.n_feeds:
                rec.full = True
                finish(c)
                start(c)
    for c in range(clients):
        if active[c] is not None:
            finish(c)
    return sessions, spans, t0, time.perf_counter()
