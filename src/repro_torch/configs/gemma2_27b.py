"""Gemma-2 27B — local+global alternating attention, logit softcaps
[arXiv:2408.00118]."""
from repro_torch.configs.base import ATTN, ATTN_LOCAL, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    layer_pattern=(ATTN_LOCAL, ATTN) * 23,
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    query_scale=144.0 ** -0.5,    # query_pre_attn_scalar = d_model / heads
    norm="rmsnorm_gemma",
    post_block_norm=True,
    scale_embeddings=True,
    act="gelu",
    tie_embeddings=True,
    source="[arXiv:2408.00118]",
)
