"""Command-R 35B — parallel-residual blocks, no biases
[hf:CohereForAI/c4ai-command-r-v01]."""
from repro_torch.configs.base import ATTN_PARALLEL, ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    layer_pattern=(ATTN_PARALLEL,) * 40,
    norm="layernorm",
    logit_scale=0.0625,
    rope_theta=8_000_000.0,
    tie_embeddings=True,
    source="[hf:CohereForAI/c4ai-command-r-v01]",
)
