"""Granite-8B-Code [arXiv:2405.04324; hf ibm-granite/granite-8b-code-base].

36L d_model=4096 32H GQA(kv=8) d_ff=14336 vocab=49152, llama-arch SwiGLU.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="granite-8b",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=49152,
    act="swiglu",
)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="granite-8b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=128, act="swiglu",
    )
