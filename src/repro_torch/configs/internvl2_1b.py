"""InternVL2-1B — InternViT frontend (stubbed) + Qwen2-0.5B language model
[arXiv:2404.16821].

Per the assignment, the vision encoder + projector are a stub:
``input_specs()`` supplies precomputed patch embeddings of shape
(batch, num_patches, d_model), which the decoder prepends to the token
embeddings. Only the language transformer is implemented here.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    modality="vision",
    num_patches=256,
    source="[arXiv:2404.16821]",
)
