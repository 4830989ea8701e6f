"""AutoInt [arXiv:1810.11921]: 39 sparse fields, embed_dim=16, 3 attention
layers, 2 heads, d_attn=32, self-attention feature interaction."""
import dataclasses

from repro_torch.configs.base import RecsysConfig

CONFIG = RecsysConfig(
    name="autoint", n_sparse=39, embed_dim=16, n_attn_layers=3, n_heads=2,
    d_attn=32, vocab_per_field=100_000,
)


def smoke_config() -> RecsysConfig:
    return dataclasses.replace(CONFIG, vocab_per_field=64, name="autoint-smoke")
