"""DeepSeekMoE-16B — 2 shared + 64 routed top-6 fine-grained experts,
first layer dense [arXiv:2401.06066]."""
from repro_torch.configs.base import ATTN, MOE, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=10944,                  # the single leading dense FFN
    dense_d_ff=10944,
    moe_d_ff=1408,
    vocab_size=102400,
    num_experts=64,
    num_experts_per_tok=6,
    num_shared_experts=2,
    norm_topk_prob=False,        # deepseek-moe does not renormalise top-k
    layer_pattern=(ATTN,) + (MOE,) * 27,
    source="[arXiv:2401.06066]",
)
