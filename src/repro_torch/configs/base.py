"""Model / run configuration system: the port's copy of
``repro.configs.base``, field for field.

Every assigned architecture is described by a ``ModelConfig``; layer
heterogeneity (gemma2 local/global alternation, zamba2 shared attention,
deepseek-moe first-dense-layer, xLSTM mLSTM/sLSTM mix) is expressed with a
``layer_pattern`` of block kinds. ``repro`` assembles them into homogeneous
scan groups; the port applies one layer after another
(`repro_torch.models.transformer`), and serves the attention kinds only.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Block kinds understood by repro_torch.models.transformer
ATTN = "attn"                  # global self-attention + MLP
ATTN_LOCAL = "attn_local"      # sliding-window self-attention + MLP
ATTN_PARALLEL = "attn_parallel"  # parallel-residual attention‖MLP (command-r)
MOE = "moe"                    # self-attention + MoE FFN
MAMBA2 = "mamba2"              # Mamba2 (SSD) block
MAMBA2_SHARED = "mamba2_shared"  # Mamba2 + the shared attention block (zamba2)
MLSTM = "mlstm"                # xLSTM matrix-memory block
SLSTM = "slstm"                # xLSTM scalar-memory block


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None    # default d_model // num_heads

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False             # qwen3-style per-head RMSNorm on q/k
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None        # used by *_local blocks
    attn_logit_softcap: Optional[float] = None  # gemma2
    final_logit_softcap: Optional[float] = None
    query_scale: Optional[float] = None         # override 1/sqrt(head_dim)
    attn_chunk: int = 512             # q-chunk for memory-bounded attention
    force_local: bool = False         # long-context variant: window everywhere

    # norm / act / misc
    norm: str = "rmsnorm"             # rmsnorm | rmsnorm_gemma | layernorm
    act: str = "silu"                 # silu | gelu
    tie_embeddings: bool = False
    mlp_gated: bool = True            # SwiGLU/GeGLU vs plain 2-layer MLP
    post_block_norm: bool = False     # gemma2 sandwich norms
    logit_scale: float = 1.0          # command-r
    use_rope: bool = True             # musicgen uses sinusoidal positions
    scale_embeddings: bool = False    # gemma2 multiplies embeddings by √d

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                 # per-expert hidden size
    dense_d_ff: int = 0               # hidden size of leading dense layers
    norm_topk_prob: bool = True
    moe_capacity_factor: float = 1.25

    # SSM / recurrent
    ssm_state: int = 0                # Mamba2 d_state
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    chunk_size: int = 256             # SSD / chunkwise-mLSTM chunk

    # modality frontend stubs (vlm / audio)
    modality: Optional[str] = None    # None | "vision" | "audio"
    num_patches: int = 256            # vision embeddings prepended per sample
    num_codebooks: int = 1            # musicgen parallel codebooks

    # explicit per-layer pattern; None → all ATTN (or MOE if num_experts)
    layer_pattern: Optional[Tuple[str, ...]] = None

    # training
    dtype: str = "bfloat16"           # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True

    # citation for the config ([arXiv:...] / [hf:...])
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def pattern(self) -> Tuple[str, ...]:
        if self.layer_pattern is not None:
            assert len(self.layer_pattern) == self.num_layers
            return self.layer_pattern
        kind = MOE if self.num_experts else ATTN
        return (kind,) * self.num_layers

    def reduced(self, *, num_layers: int = 2, d_model: int = 256,
                seq_len_hint: int = 128) -> "ModelConfig":
        """CPU-sized variant of the same family for smoke tests.

        ≤ 2 layers, d_model ≤ 512, ≤ 4 experts, same block kinds.
        """
        scale = d_model / self.d_model
        heads = max(2, min(4, self.num_heads))
        kv = max(1, min(self.num_kv_heads, heads))
        pat = None
        if self.layer_pattern is not None:
            # keep the *variety* of the pattern: first kinds, cycle-preserving
            pat = tuple(self.pattern[i % len(self.pattern)]
                        for i in range(num_layers))
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=num_layers,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=d_model // heads,
            d_ff=max(64, int(self.d_ff * scale)) if self.d_ff else 0,
            vocab_size=512,
            num_experts=min(self.num_experts, 4),
            num_experts_per_tok=min(self.num_experts_per_tok, 2),
            num_shared_experts=min(self.num_shared_experts, 1),
            moe_d_ff=min(self.moe_d_ff, 128) if self.moe_d_ff else 0,
            dense_d_ff=min(self.dense_d_ff, 256) if self.dense_d_ff else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=min(self.ssm_head_dim, 32),
            chunk_size=min(self.chunk_size, max(16, seq_len_hint // 4)),
            sliding_window=(min(self.sliding_window, seq_len_hint // 2)
                            if self.sliding_window else None),
            num_patches=min(self.num_patches, 16),
            attn_chunk=64,
            layer_pattern=pat,
            remat=False,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned workload shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def effective_window(cfg: ModelConfig, kind: str):
    """Window for an attention-bearing block.

    ``force_local=True`` is the documented long-context *variant* for pure
    full-attention archs (DESIGN.md §4): every attention block becomes
    sliding-window so the 500k decode cache stays bounded. gemma2's native
    local/global split is preserved (its global layers keep the full cache).
    """
    if kind == ATTN_LOCAL:
        return cfg.sliding_window
    if cfg.force_local:
        return cfg.sliding_window or 4096
    return None


def shape_variant(cfg: ModelConfig, shape: InputShape):
    """Adapt a config to an input shape; returns (cfg, note)."""
    import dataclasses as _dc
    if shape.name != "long_500k":
        return cfg, ""
    recurrent = any(k in (MAMBA2, MAMBA2_SHARED, MLSTM, SLSTM)
                    for k in cfg.pattern)
    if recurrent:
        return cfg, "native recurrent (O(1)-state) long-context decode"
    if ATTN_LOCAL in cfg.pattern:
        return cfg, "native local/global: local layers windowed, global full"
    note = ("sliding-window VARIANT (window=4096): the upstream model is "
            "pure full-attention and does not claim 500k support")
    return _dc.replace(cfg, force_local=True,
                       sliding_window=cfg.sliding_window or 4096), note
