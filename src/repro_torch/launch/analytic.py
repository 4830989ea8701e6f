"""Analytic FLOPs and bytes per dry-run cell, the port of
``repro/launch/analytic.py``: the closed forms that the dry run's counts
(``launch.dryrun``: ``torch.utils.flop_counter`` over one step, bytes
from a dispatch mode) are held against.

In the reference they correct XLA's cost analysis, which counts a scanned
layer loop's body once; the port loops over its layers eagerly, so its
counted FLOPs cover every layer and differ from the reference's XLA count
by design (ROADMAP.md §C). The arithmetic is the reference's, float for
float, over the port's configs and shapes, its faults included:
``triangle_bytes`` charges the f32 baseline's 3 · 4 · n² bytes although
the cell streams uint8 blocks (ROADMAP.md §C).
"""
from __future__ import annotations

from repro_torch.configs import get_config
from repro_torch.configs.shapes import shapes_for

REMAT_FACTOR = 4.0 / 3.0  # fwd is recomputed once inside bwd (≈ +fwd/ (fwd+2fwd))


def lm_flops(arch: str, shape) -> float:
    cfg = get_config(arch)
    n_active = cfg.n_active_params() if cfg.moe else cfg.n_params()
    hd_qk = (cfg.mla.nope_head_dim + cfg.mla.rope_head_dim) if cfg.mla else cfg.hd
    hd_v = cfg.mla.v_head_dim if cfg.mla else cfg.hd

    def attn_flops(tokens, kv_len):
        # scores + context, causal halves the effective kv length
        per = 2 * cfg.n_heads * (hd_qk + hd_v) * kv_len / 2
        return tokens * per

    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return (6.0 * n_active * tokens + 3 * attn_flops(tokens, shape.seq_len)) * REMAT_FACTOR
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens + attn_flops(tokens, shape.seq_len)
    # decode: one token per sequence; full kv length (no causal halving)
    t = shape.global_batch
    if cfg.mla:
        r = cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim
        attn = t * 2 * cfg.n_heads * 2 * r * shape.seq_len  # absorbed latent decode
    else:
        attn = t * 2 * cfg.n_kv_heads * 2 * cfg.hd * shape.seq_len
    return 2.0 * n_active * t + attn


def lm_bytes(arch: str, shape) -> float:
    """HBM traffic per step, global (bf16 params/cache)."""
    cfg = get_config(arch)
    p_bytes = 2.0 * cfg.n_params()
    if shape.kind == "train":
        # params read (fwd+bwd+remat ≈ 3x) + optimizer f32 m/v read+write + grads
        return 3 * p_bytes + 16.0 * cfg.n_params() + 2 * p_bytes
    if shape.kind == "prefill":
        return p_bytes + 2.0 * _cache_bytes(cfg, shape)
    return p_bytes * (cfg.n_active_params() / cfg.n_params()) + _cache_bytes(cfg, shape)


def _cache_bytes(cfg, shape) -> float:
    if cfg.mla:
        per_tok = cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim
    else:
        per_tok = 2 * cfg.n_kv_heads * cfg.hd
    return 2.0 * cfg.n_layers * shape.global_batch * shape.seq_len * per_tok


def gnn_flops(arch: str, shape) -> float:
    cfg = get_config(arch)
    e = 2 * shape.n_edges if shape.kind != "minibatch" else shape.batch_nodes * 15 * 10 * 4
    n = shape.n_nodes if shape.kind != "minibatch" else shape.batch_nodes * 160
    d = cfg.d_hidden
    if cfg.family == "gin":
        per_layer = 2 * n * d * d * 2 + e * d
    elif cfg.family == "graphcast":
        per_layer = e * (2 * 3 * d * d + 2 * d * d) + n * (2 * 2 * d * d + 2 * d * d)
    elif cfg.family == "mace":
        paths = 13
        per_layer = e * (2 * cfg.n_rbf * 64 + 2 * 64 * paths * d) + e * paths * 5 * d * 4 + n * 6 * 2 * d * d
    else:  # dimenet
        t = e * 4
        per_layer = t * (2 * cfg.n_bilinear * d + cfg.n_spherical * cfg.n_radial * cfg.n_bilinear * 2) + e * 2 * 3 * d * d
    mult = {"gin": cfg.n_layers, "graphcast": cfg.n_layers, "mace": cfg.n_layers,
            "dimenet": cfg.n_layers}[cfg.family]
    if shape.kind == "batched_small":
        per_layer *= shape.batch_graphs
    return 3.0 * per_layer * mult  # fwd + bwd


def gnn_bytes(arch: str, shape) -> float:
    cfg = get_config(arch)
    e = 2 * shape.n_edges if shape.kind != "minibatch" else shape.batch_nodes * 15 * 10 * 4
    n = shape.n_nodes if shape.kind != "minibatch" else shape.batch_nodes * 160
    d = cfg.d_hidden
    width = {"gin": d, "graphcast": 3 * d, "mace": 13 * 2 * d, "dimenet": 3 * d}[cfg.family]
    per_layer = (e * width + 2 * n * d) * 4.0
    if shape.kind == "batched_small":
        per_layer *= shape.batch_graphs
    return 3.0 * per_layer * cfg.n_layers


def recsys_flops(arch: str, shape) -> float:
    cfg = get_config(arch)
    f, d, h, da = cfg.n_sparse, cfg.embed_dim, cfg.n_heads, cfg.d_attn
    b = shape.batch if shape.kind != "retrieval" else 1
    attn = cfg.n_attn_layers * (3 * 2 * f * d * h * da + 2 * f * f * h * da * 2)
    mlp = 2 * (f * h * da) * 256 + 2 * 256 * 128
    total = b * (attn + mlp)
    if shape.kind == "train":
        total *= 3
    if shape.kind == "retrieval":
        total += 2.0 * shape.n_candidates * d
    return float(total)


def recsys_bytes(arch: str, shape) -> float:
    cfg = get_config(arch)
    b = shape.batch if shape.kind != "retrieval" else 1
    lookups = b * cfg.n_sparse * cfg.embed_dim * 4.0
    if shape.kind == "retrieval":
        return lookups + shape.n_candidates * cfg.embed_dim * 4.0
    return lookups * (3 if shape.kind == "train" else 1)


def triangle_flops(arch: str, shape) -> float:
    n = shape.n_nodes
    return 2.0 * n**3 / 6.0 * 6  # ring computes full U@U (no structural skip)


def triangle_bytes(arch: str, shape) -> float:
    n = shape.n_nodes
    # the reference's "f32 baseline", kept: the cell streams uint8 blocks, so
    # this is 4x the bytes (ROADMAP.md §C)
    return 3 * 4.0 * n * n  # U read as rows, cols and mask (f32 baseline)


def analytic_cell(arch: str, shape_name: str) -> dict | None:
    shape = next(s for s in shapes_for(arch) if s.name == shape_name)
    try:
        if arch.startswith(("deepseek", "granite", "nemotron", "yi")):
            return {"flops": lm_flops(arch, shape), "bytes": lm_bytes(arch, shape)}
        if arch in ("mace", "dimenet", "graphcast", "gin_tu"):
            return {"flops": gnn_flops(arch, shape), "bytes": gnn_bytes(arch, shape)}
        if arch == "autoint":
            return {"flops": recsys_flops(arch, shape), "bytes": recsys_bytes(arch, shape)}
        if arch == "triangle":
            return {"flops": triangle_flops(arch, shape), "bytes": triangle_bytes(arch, shape)}
    except Exception:
        return None
    return None
