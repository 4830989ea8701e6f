"""Config dataclasses of the architecture families the port runs: a copy of
the reference's (``repro/configs/base.py``), so the port imports nothing of
``repro``. ``LMConfig.n_params`` / ``n_active_params`` count exactly as the
reference counts."""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int | None = None  # None = plain q projection (V2-Lite)
    nope_head_dim: int = 128
    rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """DeepSeekMoE: shared experts always on + routed top-k."""

    n_routed: int
    n_shared: int
    top_k: int
    d_ff_expert: int
    n_dense_layers: int = 1  # first_k_dense_replace
    router_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    act: Literal["swiglu", "relu2", "geglu"] = "swiglu"
    head_dim: int | None = None
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    mla: MLAConfig | None = None
    moe: MoEConfig | None = None
    max_seq_len: int = 524_288
    tie_embeddings: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def n_params(self) -> int:
        """Total parameter count (exact for the families we build)."""
        D, L, V = self.d_model, self.n_layers, self.vocab
        total = 2 * V * D  # embed + unembed
        if self.mla is not None:
            m = self.mla
            qd = self.n_heads * (m.nope_head_dim + m.rope_head_dim)
            if m.q_lora_rank:
                attn = D * m.q_lora_rank + m.q_lora_rank * qd
            else:
                attn = D * qd
            attn += D * m.kv_lora_rank + D * m.rope_head_dim
            attn += m.kv_lora_rank * self.n_heads * (m.nope_head_dim + m.v_head_dim)
            attn += self.n_heads * m.v_head_dim * D
        else:
            attn = (D * self.n_heads * self.hd + 2 * D * self.n_kv_heads * self.hd
                    + self.n_heads * self.hd * D)

        def mlp_params(ff, gated):
            return D * ff * (3 if gated else 2)
        gated = self.act != "relu2"
        if self.moe is not None:
            mo = self.moe
            moe_layer = (
                mo.n_routed * mlp_params(mo.d_ff_expert, gated)
                + mo.n_shared * mlp_params(mo.d_ff_expert, gated)
                + D * mo.n_routed
            )
            dense_layer = mlp_params(self.d_ff, gated)
            mlp_total = mo.n_dense_layers * dense_layer + (L - mo.n_dense_layers) * moe_layer
        else:
            mlp_total = L * mlp_params(self.d_ff, gated)
        total += L * (attn + 2 * D) + mlp_total + D
        return total

    def n_active_params(self) -> int:
        """Activated parameters per token (= dense count if not MoE)."""
        if self.moe is None:
            return self.n_params()
        mo = self.moe
        gated = self.act != "relu2"
        per_expert = self.d_model * mo.d_ff_expert * (3 if gated else 2)
        inactive = (self.n_layers - mo.n_dense_layers) * (mo.n_routed - mo.top_k) * per_expert
        return self.n_params() - inactive


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    family: Literal["gin", "dimenet", "mace", "graphcast"]
    n_layers: int
    d_hidden: int
    # family extras
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    l_max: int = 2
    correlation_order: int = 3
    n_rbf: int = 8
    mesh_refinement: int = 6
    n_vars: int = 227
    aggregator: str = "sum"
    d_feat_in: int = 0  # input feature dim (0 = from shape spec)
    n_classes: int = 2


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    n_sparse: int = 39
    embed_dim: int = 16
    n_attn_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32
    vocab_per_field: int = 100_000  # hashed vocabulary per field
    mlp_hidden: tuple[int, ...] = (256, 128)


@dataclasses.dataclass(frozen=True)
class TriangleConfig:
    """The paper's own workload as a config: graph suite + ring geometry."""

    name: str = "triangle"
    n_nodes: int = 4096
    density: float = 0.5
    block: int = 128
    use_kernel: bool = True
