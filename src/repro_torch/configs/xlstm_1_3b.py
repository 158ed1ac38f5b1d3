"""xLSTM-1.3B — sLSTM + mLSTM blocks [arXiv:2405.04517]."""
from repro_torch.configs.base import MLSTM, SLSTM, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,                      # xLSTM blocks carry their own projections
    vocab_size=50304,
    layer_pattern=(MLSTM, SLSTM) * 24,
    norm="layernorm",
    act="gelu",
    use_rope=False,              # xLSTM is recurrent; no positional encoding
    chunk_size=256,
    source="[arXiv:2405.04517]",
)
