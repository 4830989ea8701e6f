"""Batched serving loops: the LM server (prefill + greedy decode over the
KV cache) and the triangle-counting server (the planner-driven
``repro_torch.api`` front end with one shared counter — one device, one
cache — across requests).

The LM server groups requests (prompt token arrays) into fixed-size
batches, pads short prompts on the left with a pad id, prefills once, then
decodes greedily until ``max_new_tokens``, as the reference's
(``repro/serve/serve_loop.py``) does. Left-pads are attended causally (no
pad mask in the step functions), so a mixed-length batch is approximate,
exactly as in the reference: a deployment would bucket requests by length
or add a pad mask.

Streaming sessions (``open_stream``/``feed``/``serve_streams`` and the
multiplexer behind them) come with the port's serving slice (ROADMAP.md,
queue A)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.models.transformer import Transformer, decode_step, prefill


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    max_new_tokens: int = 32
    pad_id: int = 0


class LMServer:
    """Greedy generation over a :class:`~repro_torch.models.transformer.
    Transformer` on the model's device. Prefill runs the chunked attention
    with ``chunk_q = min(512, prompt length)``, as the reference server's.
    Generated tokens stay on the device until a batch ends: one copy to
    the host per batch."""

    def __init__(self, model: Transformer, cfg: LMConfig, serve_cfg: ServeConfig | None = None):
        self.model = model
        self.cfg = cfg
        self.scfg = serve_cfg or ServeConfig()

    def generate(self, prompts: list[np.ndarray]) -> list[np.ndarray]:
        """Greedy-decode a list of int32 prompt arrays. Returns generated ids."""
        out: list[np.ndarray] = []
        for i in range(0, len(prompts), self.scfg.max_batch):
            out.extend(self._generate_batch(prompts[i:i + self.scfg.max_batch]))
        return out

    def _generate_batch(self, prompts: list[np.ndarray]) -> list[np.ndarray]:
        b = len(prompts)
        plen = max(len(p) for p in prompts)
        s_max = plen + self.scfg.max_new_tokens
        tokens = np.full((b, plen), self.scfg.pad_id, np.int32)
        for i, p in enumerate(prompts):
            tokens[i, plen - len(p):] = p  # left-pad → aligned last positions
        dev = self.model.device
        logits, cache = prefill(self.model, self.cfg, torch.from_numpy(tokens).to(dev), s_max,
                                chunk_q=min(512, plen))
        tok = logits.argmax(-1, keepdim=True)
        gen = [tok]
        for step in range(self.scfg.max_new_tokens - 1):
            logits, cache = decode_step(self.model, self.cfg, cache, tok, plen + step)
            tok = logits.argmax(-1, keepdim=True)
            gen.append(tok)
        stacked = torch.cat(gen, dim=1).to(torch.int32).cpu().numpy()
        return [stacked[i] for i in range(b)]


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
