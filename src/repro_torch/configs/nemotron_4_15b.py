"""Nemotron-4 15B [arXiv:2402.16819].

32L d_model=6144 48H GQA(kv=8) d_ff=24576 vocab=256000, squared-ReLU MLP
(no GLU gate — Primer-style), RoPE.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="nemotron-4-15b",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab=256000,
    act="relu2",
)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="nemotron-4-15b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=192, vocab=128, act="relu2",
    )
