"""The triangle-counting server: the planner-driven ``repro_torch.api``
front end with one shared counter (one device, one cache) across requests.

Streaming sessions (``open_stream``/``feed``/``serve_streams`` and the
multiplexer behind them) come with the port's serving slice (ROADMAP.md,
queue A)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TriangleServeConfig:
    max_batch: int = 16          # graphs per batched kernel launch
    batch_node_limit: int = 512  # dense-plan graphs up to this ride the batch path


class TriangleServer:
    """Serve triangle-count requests over ``repro_torch.api``.

    One ``TriangleCounter`` lives for the server's lifetime, on ``device``
    (``cuda`` unless ``device="cpu"`` is asked for; it raises without a
    card). Small graphs whose plan is the dense path are grouped by padded
    node bucket and counted with ONE batched live-grid kernel launch per
    group (``count_batch``, executed under the group's planner plan so the
    backend decision survives batching); everything else runs its
    planner-chosen path individually. Results come back as per-request
    ``CountResult``s in request order — counts stay device tensors, so an
    aggregating caller syncs once, not per request.
    """

    def __init__(self, resources=None, serve_cfg: TriangleServeConfig | None = None,
                 *, device=None):
        from repro_torch.api import TriangleCounter

        self.counter = TriangleCounter(resources, device=device)
        self.cfg = serve_cfg or TriangleServeConfig()

    def serve(self, graphs: list) -> list:
        from repro_torch.api import CountResult, bucket

        cfg = self.cfg
        results: list = [None] * len(graphs)
        # node bucket -> (the group's planner plan, request indices). The
        # plan rides along so count_batch executes the planner's backend
        # decision instead of Plan defaults.
        batchable: dict[int, tuple] = {}
        for i, g in enumerate(graphs):
            p = self.counter.plan_for(g)
            if p.method == "dense" and g.n_nodes <= cfg.batch_node_limit:
                batchable.setdefault(bucket(g.n_nodes), (p, []))[1].append(i)
            else:
                results[i] = self.counter.count(g, plan=p)
        for group_plan, idx in batchable.values():
            for j in range(0, len(idx), cfg.max_batch):
                chunk = idx[j:j + cfg.max_batch]
                rb = self.counter.count_batch([graphs[i] for i in chunk],
                                              plan=group_plan)
                for pos, i in enumerate(chunk):
                    # amortized share of the batch call, so summing wall_s
                    # over a response doesn't multiply-count the batch (the
                    # full batch time stays in stats)
                    results[i] = CountResult(
                        count=rb.count[pos], plan=rb.plan,
                        wall_s=rb.wall_s / len(chunk),
                        stats={**rb.stats, "batched": True, "batch_pos": pos,
                               "batch_wall_s": rb.wall_s},
                    )
        return results
