"""Zamba2-1.2B — Mamba2 backbone + shared attention block
[arXiv:2411.15242].

The shared transformer block (attention + MLP with a single set of weights)
is applied at every 6th layer on top of the Mamba2 block, re-using the same
parameters at each application — the paper's parameter-sharing scheme.
"""
from repro_torch.configs.base import MAMBA2, MAMBA2_SHARED, ModelConfig

_pattern = tuple(
    MAMBA2_SHARED if (i % 6) == 5 else MAMBA2 for i in range(38))

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,                   # shared block MLP
    vocab_size=32000,
    layer_pattern=_pattern,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    source="[arXiv:2411.15242]",
)
