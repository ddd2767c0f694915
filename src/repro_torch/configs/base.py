"""Model / run configuration dataclasses (plain dataclasses, no deps)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | xlstm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None            # default d_model // n_heads

    # attention
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0              # glm4 rotates half the dims
    qkv_bias: bool = False                  # qwen1.5
    attn_softcap: float | None = None       # gemma2
    final_softcap: float | None = None      # gemma2
    sliding_window: int | None = None       # gemma2 local layers
    local_global: bool = False              # gemma2 alternating pattern
    attn_impl: str = "auto"                 # auto | flash | torch (CPU only)

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    moe_interleave: int = 1                 # every k-th layer is MoE
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM / xLSTM / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_heads: int = 0
    ssm_chunk: int = 64
    slstm_every: int = 0                    # xlstm: 1-in-k blocks is sLSTM
    shared_attn_every: int = 0              # zamba2
    n_shared_attn_blocks: int = 2           # zamba2

    # enc-dec
    n_enc_layers: int = 0
    n_dec_layers: int = 0

    # multimodal stubs (frontends provide precomputed embeddings)
    n_patches: int = 0
    frontend_dim: int = 0

    # distribution knobs (perf-iterated; see EXPERIMENTS.md §Perf)
    decode_kv_shard: str = "heads"          # heads | seq (flash-decode SP)
    tp_internals: bool = True               # TP block internals over 'model'
    moe_dispatch: str = "gspmd"             # gspmd | shard_map_ep
    sp_residual: bool = False               # Megatron-SP: seq-shard residual

    # numerics / execution
    mlp_act: str = "silu"                   # silu | gelu (gemma2)
    embed_scale: bool = False               # gemma2 scales by sqrt(d)
    post_norms: bool = False                # gemma2 post-block norms
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    dtype: str = "float32"                  # activation/param dtype
    remat: str = "none"                     # none | dots | full
    fsdp: bool = True                       # shard params over the data axis
    subquadratic: bool = False              # may run long_500k decode

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# smoke-test shape (reduced configs, CPU)
SMOKE = ShapeConfig("smoke", 64, 2, "train")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False
    return True
