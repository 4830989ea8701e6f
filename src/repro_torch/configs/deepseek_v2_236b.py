"""DeepSeek-V2 236B [arXiv:2405.04434; hf deepseek-ai/DeepSeek-V2].

60L d_model=5120 128H, MLA kv_lora=512 + q_lora=1536 (nope 128 / rope 64 /
v 128), MoE: 160 routed top-6 + 2 shared, d_ff_expert=1536, first layer dense
(d_ff=12288), vocab 102400.
"""
from repro_torch.configs.base import LMConfig, MLAConfig, MoEConfig

CONFIG = LMConfig(
    name="deepseek-v2-236b",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,  # dense (first) layer
    vocab=102400,
    act="swiglu",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, nope_head_dim=128, rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_routed=160, n_shared=2, top_k=6, d_ff_expert=1536, n_dense_layers=1),
)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="deepseek-v2-236b-smoke",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=128,
        act="swiglu",
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, nope_head_dim=16, rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(n_routed=8, n_shared=1, top_k=2, d_ff_expert=32, n_dense_layers=1),
    )
