"""Ring attention on the dynamic-pipeline runtime, the port of
``repro/models/ring_attention.py``.

Exact blockwise-softmax causal attention with O(S·block) memory per stage:
each ring stage owns one query block (its "responsible" sequence range) and
the KV blocks stream through the ring — the same :class:`~repro_torch.core.
dynamic_pipeline.FilterSpec` dataflow that counts triangles (edges → KV
blocks, adjacency partition → query blocks). ``mesh=None`` runs the stage
chain (:func:`~repro_torch.core.dynamic_pipeline.run_sequential`); a
:class:`~repro_torch.launch.RingMesh` runs the ring, each stage on its own
device and CUDA stream (``make_ring_mesh(4, devices=[cuda:0] * 4)`` puts
four stages on one card).

The stage id is a 0-d tensor on the stage's device, so ``process`` never
reads it to the host. Where autograd records no graph, ``process`` updates
its (B, H, block, block) scores and its state in place, so a stage holds one
score block at a time.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.dynamic_pipeline import FilterSpec, mesh_runtime, run_sequential
from repro_torch.utils import records_grad

_NEG = -1e30  # the reference's mask value (not -inf: a masked row stays finite)


# Memoized as the reference's lru_cache: repeated calls hand the runtimes one
# FilterSpec object, on which DynamicPipeline.jit keys its memo.
@functools.lru_cache(maxsize=None)
def ring_attention_spec(block: int, n_stages: int, d: int, *, causal: bool = True,
                        scale: float | None = None) -> FilterSpec:
    """Resident = (me, q_block); stream = (k_block, v_block) pairs.

    The state carries the online-softmax triple (m, l, acc) in float32;
    ``finalize`` normalizes and places the stage's block at its index of
    an (n_stages, B, H, block, D) partial, so the runtimes' sum over the
    stages concatenates the blocks."""
    if scale is None:
        scale = d**-0.5

    def init(resident):
        me, q = resident  # me: 0-d int32 stage id; q: (B, H, block, D)
        b, h = q.shape[0], q.shape[1]
        f32 = dict(dtype=torch.float32, device=q.device)
        return {"me": me, "q": q,
                "m": torch.full((b, h, block, 1), _NEG, **f32),
                "l": torch.zeros((b, h, block, 1), **f32),
                "acc": torch.zeros((b, h, block, d), **f32)}

    def process(state, kv, src: int):
        k, v = kv
        q = state["q"]
        inplace = not records_grad(q, k, v)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))  # (B, H, bq, bk)
        logits = logits.mul_(scale) if inplace else logits * scale
        if causal:
            ar = torch.arange(block, device=q.device)
            masked = (state["me"] * block + ar[:, None]) < (src * block + ar[None, :])
            logits = (logits.masked_fill_(masked, _NEG) if inplace
                      else logits.masked_fill(masked, _NEG))
        m_new = torch.maximum(state["m"], logits.amax(-1, keepdim=True))
        p = logits.sub_(m_new).exp_() if inplace else torch.exp(logits - m_new)
        alpha = torch.exp(state["m"] - m_new)
        pv = torch.matmul(p, v.float())
        if inplace:
            state["l"].mul_(alpha).add_(p.sum(-1, keepdim=True))
            state["acc"].mul_(alpha).add_(pv)
            state["m"] = m_new
            return state
        return {"me": state["me"], "q": q, "m": m_new,
                "l": alpha * state["l"] + p.sum(-1, keepdim=True),
                "acc": alpha * state["acc"] + pv}

    def finalize(state):
        out = state["acc"] / torch.clamp(state["l"], min=1e-30)
        # one-hot place the stage's block so the sum over stages concatenates
        onehot = (torch.arange(n_stages, device=out.device) == state["me"]).to(out.dtype)
        return onehot.reshape(n_stages, 1, 1, 1, 1) * out[None]

    return FilterSpec(init=init, process=process, finalize=finalize)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, n_stages: int,
                   mesh=None, causal: bool = True) -> torch.Tensor:
    """q, k, v: (B, H, S, D) with S divisible by ``n_stages``. ``mesh=None``
    (or a mesh of one stage) runs the sequential stage chain; a
    :class:`~repro_torch.launch.RingMesh` of ``n_stages`` stages runs the
    ring. Returns (B, H, S, D) in q's dtype, on stage 0's device."""
    b, h, s, d = q.shape
    if s % n_stages:
        raise ValueError(f"sequence length {s} is not divisible by {n_stages} stages")
    block = s // n_stages

    def blocks(x):  # (B, H, S, D) -> (n_stages, B, H, block, D), a view
        return x.reshape(b, h, n_stages, block, d).movedim(2, 0)

    ids = torch.arange(n_stages, dtype=torch.int32, device=q.device)
    spec = ring_attention_spec(block, n_stages, d, causal=causal)
    resident, stream = (ids, blocks(q)), (blocks(k), blocks(v))
    if mesh is None or mesh.size == 1:
        out = run_sequential(spec, resident, stream, n_stages)
    else:
        if mesh.size != n_stages:
            raise ValueError(f"a mesh of {mesh.size} stages runs n_stages={mesh.size}, "
                             f"not {n_stages}")
        out = mesh_runtime(mesh, mesh.axis_names[0]).pipeline.jit(spec)(resident, stream)
    # (n_stages, B, H, block, D) -> (B, H, S, D)
    return out.movedim(0, 2).reshape(b, h, s, d).to(q.dtype)
