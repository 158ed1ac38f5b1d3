"""Qwen3-30B-A3B — 128-expert top-8 MoE, QK-norm [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import MOE, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,                       # every FFN is MoE
    moe_d_ff=768,
    vocab_size=151936,
    num_experts=128,
    num_experts_per_tok=8,
    norm_topk_prob=True,
    qk_norm=True,
    rope_theta=1_000_000.0,
    layer_pattern=(MOE,) * 48,
    source="[hf:Qwen/Qwen3-30B-A3B]",
)
