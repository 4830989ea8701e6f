"""Yi-6B [arXiv:2403.04652; hf 01-ai/Yi-6B].

32L d_model=4096 32H GQA(kv=4) d_ff=11008 vocab=64000, llama-arch SwiGLU.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="yi-6b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    act="swiglu",
    rope_theta=5_000_000.0,
)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="yi-6b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=128, vocab=128, act="swiglu",
    )
