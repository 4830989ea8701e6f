"""Partitioned full-graph message passing on a ring mesh, the port of
``repro/models/gnn/distributed.py``.

The reference expresses the dynamic pipeline's partitioning in shapes
GSPMD partitions over the flattened mesh. The port holds the
same partition on a :class:`~repro_torch.launch.RingMesh`, one process
driving every stage (a 2-D :class:`~repro_torch.launch.Mesh` is taken
flattened in mesh order, as the reference's ``_flat_axes`` flattens it:
its coordinates are the stages):

- node states h (N, d) are S row shards, shard s the rows [s·n_loc,
  (s+1)·n_loc) on ``mesh.devices[s]`` (n_loc = N // S; N must divide);
- edges are pre-partitioned on the host BY DESTINATION shard
  (:func:`partition_edges_by_dst`) and reshaped to (S, e_loc, 2), stage s's
  block on stage s's device, so the scatter of a stage's messages lands in
  its own n_loc rows (:func:`local_scatter_sum`) and needs no collective;
- the only collective is the gather of h's shards that feeds the edge
  gather (:func:`replicate_rows`), which XLA inserts in the reference: on
  stages that share a device it is one concatenated (N, d) tensor that
  every stage reads, across devices one copy of each shard to each
  device;
- a layer (GIN, GraphCast) or a layer and each edge chunk (MACE) or a
  block (DimeNet) is a non-reentrant ``torch.utils.checkpoint`` where the
  reference has ``jax.checkpoint``.

The stages' work is issued in stage order on the caller's stream, not on
per-stage streams as ``core.dynamic_pipeline`` issues the triangle ring:
autograd replays each backward op on its forward op's stream, and a
tensor one stage's stream allocates and another reads (the gathered h,
the saved activations, the gradients that flow back into the shared
weights) would each need ``record_stream`` or an allocation from the
caller's pool. That is not done here; on one card the stages' kernels
are large enough to fill it alone.

``_cst``, ``_cst_axis1`` and ``multi_axis_index`` have no counterpart:
they are GSPMD sharding hints and an SPMD device index, and in the port a
shard's layout is where it was put and the stage index is the loop
variable.

The loss builders keep the reference's contract: ``builder(model, cfg,
mesh, **kw)`` returns ``loss(model, batch)``, the batch holding the global
arrays (numpy or tensors). ``compute_dtype`` (GraphCast, MACE) casts each
weight inside the loss with a differentiable ``.to``, so gradients and
AdamW's state stay float32; the single-device models stay float32 only.

DimeNet keeps the reference's triplet rule exactly: a triplet counts only
where both its edges fall in its own shard's slot range, and with edges
partitioned by dst a triplet's two edges (k→j, j→i) mostly do not, so at
S > 1 most triplets are dropped (ROADMAP.md §C).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import GNNConfig
from repro_torch.launch.mesh import flat_ring
from repro_torch.models.gnn import common as C
from repro_torch.models.gnn.cg import sh_l
from repro_torch.models.gnn.dimenet import bilinear_apply, radial_basis, spherical_basis
from repro_torch.models.gnn.mace import _cg_contract, _paths


def partition_edges_by_dst(edges, n_nodes_pad: int, n_devices: int):
    """Host-side: bucket (global-id) edges by dst row range. Returns
    ((n_devices * e_loc, 2) int32 padded with n_nodes_pad, e_loc)."""
    edges = np.asarray(edges)
    rows = n_nodes_pad // n_devices
    shard = np.minimum(edges[:, 1] // rows, n_devices - 1)
    shard = np.where(edges[:, 1] >= n_nodes_pad, -1, shard)
    counts = np.bincount(shard[shard >= 0], minlength=n_devices)
    e_loc = max(int(counts.max()), 1)
    e_loc = -(-e_loc // 8) * 8
    out = np.full((n_devices * e_loc, 2), n_nodes_pad, dtype=np.int32)
    for s in range(n_devices):
        rows_s = edges[shard == s]
        out[s * e_loc : s * e_loc + len(rows_s)] = rows_s
    return out, e_loc


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------
def _n_loc(n: int, mesh) -> int:
    if n % mesh.size:
        raise ValueError(f"{n} node rows do not split over {mesh.size} stages: the partition "
                         "needs N divisible by the mesh size")
    return n // mesh.size


def row_shards(a, mesh) -> list:
    """A global (N, ...) array (numpy or tensor) as S row shards, shard s on
    ``mesh.devices[s]``."""
    a = torch.as_tensor(a)
    n_loc = _n_loc(a.shape[0], mesh)
    return [a[s * n_loc:(s + 1) * n_loc].to(dev) for s, dev in enumerate(mesh.devices)]


def edge_shards(edges, mesh) -> list:
    """Partitioned edges (S · e_loc, 2) as S blocks (e_loc, 2) of int64, block
    s on ``mesh.devices[s]``."""
    e = torch.as_tensor(edges)
    if e.shape[0] % mesh.size:
        raise ValueError(f"{e.shape[0]} partitioned edges do not split over {mesh.size} stages")
    e = e.reshape(mesh.size, -1, 2)
    return [e[s].to(dev, torch.int64) for s, dev in enumerate(mesh.devices)]


def on_devices(a, mesh) -> dict:
    """A global array on each distinct device of the mesh, by device."""
    a = torch.as_tensor(a)
    return {dev: a.to(dev) for dev in mesh.physical_devices()}


def replicate_rows(shards: list, mesh) -> list:
    """The all-gather of S row shards: for each stage the whole (N, ...)
    tensor on its device. Stages that share a device share one tensor,
    concatenated there once; a shard on another device is copied to it."""
    if len(shards) == 1:
        return list(shards)
    full = {dev: torch.cat([sh.to(dev) for sh in shards]) for dev in mesh.physical_devices()}
    return [full[dev] for dev in mesh.devices]


def gather_rows(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """h: (N, d) (one stage's replicated tensor); idx: any shape of global
    ids (phantom = N). Returns the rows with phantom rows zeroed."""
    n = h.shape[0]
    flat = idx.reshape(-1)
    rows = h[torch.clamp(flat, max=n - 1)]
    rows = rows * (flat < n)[:, None].to(h.dtype)
    return rows.reshape(*idx.shape, h.shape[-1])


def local_scatter_sum(msg: torch.Tensor, dst: torch.Tensor, n_loc: int, s: int) -> torch.Tensor:
    """Stage s's messages msg (e_loc, d) summed into its n_loc rows by their
    GLOBAL dst ids (e_loc,), with the reference's arithmetic: an id below
    the shard's range clips to its row 0, and one above it (a phantom
    among them) is dropped."""
    local = torch.clamp(dst - s * n_loc, 0, n_loc)
    return C.segment_sum(msg, local, n_loc)


def local_take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Within-shard gather: arr (E[, d]); idx (T,) LOCAL slot ids."""
    return arr[idx]


def local_segment_sum(vals: torch.Tensor, ids: torch.Tensor, num: int) -> torch.Tensor:
    """Within-shard segment sum: vals (T, d); ids (T,) LOCAL ids in [0, num)."""
    return C.segment_sum(vals, ids, num)


# ---------------------------------------------------------------------------
# the weights on each device, in the compute dtype
# ---------------------------------------------------------------------------
def _weights(model, mesh, dtype=None) -> dict:
    """{device: {parameter name: tensor}}: each parameter moved to each
    distinct device of the mesh and cast to ``dtype`` where one is given,
    differentiably (the parameter itself where nothing changes)."""
    params = dict(model.named_parameters())
    return {dev: {k: p.to(dev, dtype or p.dtype) for k, p in params.items()}
            for dev in mesh.physical_devices()}


def _sub(ws: dict, prefix: str) -> dict:
    """The tensors under ``prefix`` in one device's weights, by leaf name
    (``"w0"``, ``"b0"``, ...), as ``common.mlp_apply`` takes an MLP."""
    p = prefix + "."
    return {k[len(p):]: v for k, v in ws.items() if k.startswith(p)}


def _ckpt(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


def _gathered_sum(parts: list, device) -> torch.Tensor:
    """Σ of per-stage 0-d tensors, on ``device``."""
    return sum(p.to(device) for p in parts)


# ---------------------------------------------------------------------------
# family instances
# ---------------------------------------------------------------------------
def gin_distributed_loss(model, cfg: GNNConfig, mesh):
    mesh = flat_ring(mesh)
    devs = mesh.devices

    def one_layer(w, i, h, edges, n_loc):
        full = replicate_rows(h, mesh)
        out = []
        for s, dev in enumerate(devs):
            msg = gather_rows(full[s], edges[s][:, 0])
            agg = local_scatter_sum(msg, edges[s][:, 1], n_loc, s)
            out.append(C.mlp_apply(_sub(w[dev], f"layers.{i}.mlp"),
                                   (1.0 + w[dev][f"layers.{i}.eps"]) * h[s] + agg,
                                   act=F.relu, final_act=True))
        return out

    def loss(model, batch):
        edges = edge_shards(batch["edges"], mesh)
        h = row_shards(batch["x"], mesh)
        n_loc = h[0].shape[0]
        w = _weights(model, mesh)
        for i in range(len(model.layers)):
            h = _ckpt(one_layer, w, i, h, edges, n_loc)
        labels = row_shards(batch["labels"], mesh)
        nll = []
        for s, dev in enumerate(devs):
            logits = C.mlp_apply(_sub(w[dev], "readout"), h[s]).float()
            logp = torch.log_softmax(logits, dim=-1)
            nll.append(-torch.sum(torch.take_along_dim(logp, labels[s].long()[:, None], dim=1)))
        return _gathered_sum(nll, model.device) / (n_loc * mesh.size)

    return loss


def graphcast_distributed_loss(model, cfg: GNNConfig, mesh, *, remat: bool = True,
                               compute_dtype=None):
    """One checkpoint per layer with ``remat`` (the reference's scan body)."""
    mesh = flat_ring(mesh)
    devs = mesh.devices

    def body(w, i, h, e, edges, n_loc):
        full = replicate_rows(h, mesh)
        h_out, e_out = [], []
        for s, dev in enumerate(devs):
            src, dst = edges[s][:, 0], edges[s][:, 1]
            h_src, h_dst = gather_rows(full[s], src), gather_rows(full[s], dst)
            e_s = e[s] + C.mlp_apply(_sub(w[dev], f"layers.{i}.edge_mlp"),
                                     torch.cat([h_src, h_dst, e[s]], -1))
            agg = local_scatter_sum(e_s, dst, n_loc, s)
            h_out.append(h[s] + C.layer_norm(
                C.mlp_apply(_sub(w[dev], f"layers.{i}.node_mlp"), torch.cat([h[s], agg], -1))))
            e_out.append(e_s)
        return h_out, e_out

    def loss(model, batch):
        edges = edge_shards(batch["edges"], mesh)
        x, target = row_shards(batch["x"], mesh), row_shards(batch["target"], mesh)
        if compute_dtype is not None:
            x = [a.to(compute_dtype) for a in x]
        n_loc = x[0].shape[0]
        w = _weights(model, mesh, compute_dtype)
        h = [C.mlp_apply(_sub(w[dev], "encoder"), x[s]) for s, dev in enumerate(devs)]
        e = [C.mlp_apply(_sub(w[dev], "edge_embed"), h[s].new_zeros((edges[s].shape[0], 4)))
             for s, dev in enumerate(devs)]
        for i in range(len(model.layers)):
            h, e = (_ckpt if remat else (lambda f, *a: f(*a)))(body, w, i, h, e, edges, n_loc)
        sq = [torch.sum(torch.square(C.mlp_apply(_sub(w[dev], "decoder"), h[s]).float()
                                     - target[s].float())) for s, dev in enumerate(devs)]
        return _gathered_sum(sq, model.device) / (n_loc * mesh.size * target[0].shape[-1])

    return loss


def mace_distributed_loss(model, cfg: GNNConfig, mesh, *, compute_dtype=None):
    """Flattened-irrep node states, CG-path edge math, local scatter; each
    stage's edges in ``n_chunks`` chunks (a checkpoint each), one source
    gather per l1."""
    mesh = flat_ring(mesh)
    devs = mesh.devices
    lm, c = cfg.l_max, cfg.d_hidden
    paths = _paths(lm)
    dims = [2 * l + 1 for l in range(lm + 1)]
    off = [0]
    for d in dims:
        off.append(off[-1] + d * c)

    def split(hf):
        return {l: hf[..., off[l]:off[l + 1]].reshape(*hf.shape[:-1], dims[l], c)
                for l in range(lm + 1)}

    def chunk_body(w, i, a, hs_full, chunks, n, n_loc):
        out = []
        for s, dev in enumerate(devs):
            s_c, d_c, shc, rc = chunks[s]
            wr = C.mlp_apply(_sub(w[dev], f"layers.{i}.radial"), rc).reshape(-1, len(paths), c)
            hj_by_l1 = {}
            for l1 in range(lm + 1):
                hj = hs_full[s][l1].reshape(n, dims[l1] * c)[torch.clamp(s_c, max=n - 1)]
                hj = hj * (s_c < n)[:, None].to(hj.dtype)
                hj_by_l1[l1] = hj.reshape(-1, dims[l1], c)
            a_s = dict(a[s])
            for pi, (l1, l2, l3) in enumerate(paths):
                msg = _cg_contract(hj_by_l1[l1], shc[l2].reshape(-1, dims[l2]), l1, l2, l3)
                msg = msg * wr[:, pi, :].reshape(-1, 1, c)
                agg = local_scatter_sum(msg.reshape(-1, dims[l3] * c), d_c, n_loc, s)
                a_s[l3] = a_s[l3] + agg.reshape(n_loc, dims[l3], c)
            out.append(a_s)
        return out

    def one_layer(w, i, h_flat, energy, chunks, k, n, n_loc):
        h_full = replicate_rows(h_flat, mesh)
        hs_full = [split(t) for t in h_full]
        a = [{l: h_flat[s].new_zeros((n_loc, dims[l], c)) for l in range(lm + 1)}
             for s in range(len(devs))]
        for kk in range(k):
            a = _ckpt(chunk_body, w, i, a, hs_full, [ch[kk] for ch in chunks], n, n_loc)
        h_out, e_out = [], []
        for s, dev in enumerate(devs):
            hs, a_s = split(h_flat[s]), a[s]
            b2 = {l: torch.zeros_like(a_s[l]) for l in range(lm + 1)}
            b3 = {l: torch.zeros_like(a_s[l]) for l in range(lm + 1)}
            for l1, l2, l3 in paths:
                b2[l3] = b2[l3] + _cg_contract(a_s[l1], a_s[l2], l1, l2, l3)
            for l1, l2, l3 in paths:
                b3[l3] = b3[l3] + _cg_contract(b2[l1], a_s[l2], l1, l2, l3)
            ws = w[dev]
            newh = {l: (a_s[l] @ ws[f"layers.{i}.mix_a.{l}"]
                        + b2[l] @ ws[f"layers.{i}.mix_b2.{l}"]
                        + b3[l] @ ws[f"layers.{i}.mix_b3.{l}"]
                        + hs[l] @ ws[f"layers.{i}.res.{l}"]) for l in range(lm + 1)}
            h_out.append(torch.cat([newh[l].reshape(n_loc, dims[l] * c)
                                    for l in range(lm + 1)], -1))
            e_site = C.mlp_apply(_sub(ws, f"layers.{i}.readout"), newh[0][:, 0, :])[:, 0].float()
            e_out.append(energy[s] + e_site)
        return h_out, e_out

    def loss(model, batch, n_chunks: int = 8):
        edges = edge_shards(batch["edges"], mesh)
        z, target = torch.as_tensor(batch["z"]), torch.as_tensor(batch["target"])
        pos = on_devices(batch["pos"], mesh)
        if compute_dtype is not None:
            pos = {dev: p.to(compute_dtype) for dev, p in pos.items()}
        n = z.shape[0]
        n_loc = _n_loc(n, mesh)
        e_loc = edges[0].shape[0]
        k = n_chunks if e_loc % n_chunks == 0 else 1
        ck = e_loc // k
        w = _weights(model, mesh, compute_dtype)

        chunks = []  # per stage, per chunk: (src, dst, {l: sh}, rbf)
        for s, dev in enumerate(devs):
            src, dst = edges[s][:, 0], edges[s][:, 1]
            p_src, p_dst = gather_rows(pos[dev], src), gather_rows(pos[dev], dst)
            dt = pos[dev].dtype
            valid = (src < n)[:, None].to(dt)
            vec = (p_dst - p_src) * valid
            dist = torch.linalg.vector_norm(vec + 1e-9, dim=-1)
            unit = vec / torch.clamp(dist, min=1e-9)[:, None]
            sh = {l: (sh_l(unit, l) * valid).to(dt) for l in range(lm + 1)}
            rbf = (radial_basis(dist, cfg.n_rbf, 5.0) * valid).to(dt)
            cut = lambda t, kk: t[kk * ck:(kk + 1) * ck]  # noqa: E731
            chunks.append([(cut(src, kk), cut(dst, kk), {l: cut(sh[l], kk) for l in sh},
                            cut(rbf, kk)) for kk in range(k)])

        h_flat, energy = [], []
        for s, dev in enumerate(devs):
            species = w[dev]["species"]
            z_s = z[s * n_loc:(s + 1) * n_loc].to(dev).long()
            h0 = species[torch.clamp(z_s, max=species.shape[0] - 1)]
            h_flat.append(torch.cat([h0] + [h0.new_zeros((n_loc, dims[l] * c))
                                            for l in range(1, lm + 1)], -1))
            energy.append(torch.zeros((n_loc,), dtype=torch.float32, device=dev))
        for i in range(len(model.layers)):
            h_flat, energy = _ckpt(one_layer, w, i, h_flat, energy, chunks, k, n, n_loc)
        e_tot = _gathered_sum([torch.sum(e) for e in energy], model.device)
        return torch.mean(torch.square(e_tot - target.to(model.device)[0]))

    return loss


def in_shard_triplets(triplets, mesh, e_loc: int) -> list:
    """The reference's triplet rule, stage by stage: the global triplets
    (S · t_loc, 2) (edge_kj, edge_ji) cut into S blocks, block s's local slot
    ids (clipped into [0, e_loc)) and its mask of triplets whose two edges
    both fall in stage s's slot range [s · e_loc, (s+1) · e_loc). Returns
    [(t_kj, t_ji, in_shard)] on the stages' devices."""
    trip = torch.as_tensor(triplets)
    if trip.shape[0] % mesh.size:
        raise ValueError(f"{trip.shape[0]} triplets do not split over {mesh.size} stages")
    trip = trip.reshape(mesh.size, -1, 2)
    out = []
    for s, dev in enumerate(mesh.devices):
        t = trip[s].to(dev, torch.int64) - s * e_loc
        inside = (t >= 0) & (t < e_loc)
        out.append((torch.clamp(t[:, 0], 0, e_loc - 1), torch.clamp(t[:, 1], 0, e_loc - 1),
                    inside[:, 0] & inside[:, 1]))
    return out


def dimenet_distributed_loss(model, cfg: GNNConfig, mesh):
    """Edge-centric: edge messages live with their dst's shard; a triplet
    keeps the reference's in-shard rule (:func:`in_shard_triplets`)."""
    mesh = flat_ring(mesh)
    devs = mesh.devices

    def one_block(w, i, m, energy, geo, n_loc):
        m_out, e_out = [], []
        for s, dev in enumerate(devs):
            ws, (dst, rbf, sbf, t_kj, t_ji, valid_t) = w[dev], geo[s]
            p = f"blocks.{i}"
            t_msg = local_take(C.mlp_apply(_sub(ws, f"{p}.mlp_src"), m[s]), t_kj) * valid_t
            sb = sbf @ ws[f"{p}.w_sbf"]
            tri = bilinear_apply(sb, ws[f"{p}.w_bil"], t_msg)
            agg = local_segment_sum(tri, t_ji, m[s].shape[0])
            m_s = m[s] + C.mlp_apply(_sub(ws, f"{p}.mlp_out"), m[s] + agg)
            gated = m_s * C.mlp_apply(_sub(ws, f"{p}.out_rbf"), rbf)
            node = local_scatter_sum(gated, dst, n_loc, s)
            m_out.append(m_s)
            e_out.append(energy[s] + C.mlp_apply(_sub(ws, f"{p}.out_mlp"), node)[:, 0].float())
        return m_out, e_out

    def loss(model, batch):
        edges = edge_shards(batch["edges"], mesh)
        z, target = torch.as_tensor(batch["z"]), torch.as_tensor(batch["target"])
        pos, zs = on_devices(batch["pos"], mesh), on_devices(z, mesh)
        n = z.shape[0]
        n_loc = _n_loc(n, mesh)
        e_loc = edges[0].shape[0]
        trips = in_shard_triplets(batch["triplets"], mesh, e_loc)
        w = _weights(model, mesh)
        geo, m, energy = [], [], []
        for s, dev in enumerate(devs):
            ws, src, dst = w[dev], edges[s][:, 0], edges[s][:, 1]
            t_kj, t_ji, in_shard = trips[s]
            valid_e = (src < n)[:, None].to(pos[dev].dtype)
            vec = (gather_rows(pos[dev], dst) - gather_rows(pos[dev], src)) * valid_e
            dist = torch.linalg.vector_norm(vec + 1e-9, dim=-1)
            rbf = radial_basis(dist, cfg.n_radial, 5.0) * valid_e
            valid_t = in_shard[:, None].to(pos[dev].dtype)
            v1, v2 = -local_take(vec, t_kj), local_take(vec, t_ji)
            norms = torch.linalg.vector_norm(v1, dim=-1) * torch.linalg.vector_norm(v2, dim=-1)
            cosang = torch.sum(v1 * v2, -1) / torch.clamp(norms, min=1e-9)
            angle = torch.arccos(torch.clamp(cosang, -1 + 1e-6, 1 - 1e-6))
            sbf = spherical_basis(local_take(dist, t_kj), angle, cfg.n_spherical,
                                  cfg.n_radial, 5.0) * valid_t
            species = ws["species"]
            h = species[torch.clamp(zs[dev].long(), max=species.shape[0] - 1)]
            h_src, h_dst = gather_rows(h, src), gather_rows(h, dst)
            m.append(C.mlp_apply(_sub(ws, "embed_mlp"), torch.cat(
                [h_src, h_dst, C.mlp_apply(_sub(ws, "rbf_proj"), rbf)], -1)))
            geo.append((dst, rbf, sbf, t_kj, t_ji, valid_t))
            energy.append(torch.zeros((n_loc,), dtype=torch.float32, device=dev))
        for i in range(len(model.blocks)):
            m, energy = _ckpt(one_block, w, i, m, energy, geo, n_loc)
        e_tot = _gathered_sum([torch.sum(e) for e in energy], model.device)
        return torch.mean(torch.square(e_tot - target.to(model.device)[0]))

    return loss


_BUILDERS = {
    "gin": gin_distributed_loss,
    "graphcast": graphcast_distributed_loss,
    "mace": mace_distributed_loss,
    "dimenet": dimenet_distributed_loss,
}


def make_distributed_gnn_train_step(cfg: GNNConfig, mesh, opt_cfg=None, compute_dtype=None):
    """One AdamW step (no weight decay by default) on the family's
    partitioned loss over ``mesh``; ``compute_dtype`` applies to MACE and
    GraphCast. Returns ``step(model, opt_state, batch) -> (model,
    opt_state, {"loss"})``, updating in place as ``train.steps`` does."""
    from repro_torch.train import optimizer as opt
    from repro_torch.train.steps import _train_step

    mesh = flat_ring(mesh)

    builder = _BUILDERS[cfg.family]
    kw = {}
    if compute_dtype is not None and cfg.family in ("mace", "graphcast"):
        kw["compute_dtype"] = compute_dtype

    def loss(model, batch):
        return builder(model, cfg, mesh, **kw)(model, batch)

    return _train_step(loss, opt_cfg or opt.AdamWConfig(weight_decay=0.0))
