"""MusicGen-medium — decoder-only transformer over EnCodec tokens
[arXiv:2306.05284].

The EnCodec tokenizer / mel front-end is a stub per the assignment:
``input_specs()`` provides the (batch, seq, num_codebooks) discrete token
grid directly. The decoder embeds and sums the 4 codebooks (delay pattern
is a data-layout concern handled by the pipeline) and predicts all 4
codebooks per step through parallel output heads.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    norm="layernorm",
    act="gelu",
    mlp_gated=False,
    use_rope=False,              # sinusoidal positions, as in the paper
    modality="audio",
    num_codebooks=4,
    source="[arXiv:2306.05284]",
)
