"""ArchConfig: one declarative description drives init, apply, sharding,
input specs, and the dry-run for every assigned architecture."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str              # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    norm: str = "rms"        # rms | layer
    gated_mlp: bool = True
    act: str = "silu"
    rotary_frac: float = 1.0
    rope_theta: float = 10000.0
    attn_bias: bool = False
    # --- MoE ---
    moe: bool = False
    n_routed: int = 0
    n_shared: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    first_dense: int = 1
    # --- MLA ---
    mla: bool = False
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    # --- SSM / hybrid ---
    ssm_state: int = 0
    mamba_head_dim: int = 64
    mamba_expand: int = 2
    attn_every: int = 0      # hybrid: shared attn block after every k blocks
    slstm_every: int = 0     # xlstm: every k-th block is sLSTM
    # --- encoder-decoder (audio) ---
    enc_layers: int = 0
    enc_seq: int = 0
    use_rope: bool = True    # whisper uses learned/sinusoidal abs positions
    # --- VLM ---
    prefix_len: int = 0      # patch-embedding prefix from the stub frontend
    # --- long context ---
    long_context_ok: bool = False
    long_sliding_window: int = 4096
    max_decode_len: int = 0  # 0 = unrestricted

    def with_overrides(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                # train | prefill | decode


SHAPES: dict = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) is a well-defined cell (DESIGN.md S4)."""
    if shape.name == "long_500k" and not cfg.long_context_ok:
        return False, "full-attention arch: 500k decode is quadratic-infeasible"
    if cfg.max_decode_len and shape.kind == "decode" \
            and shape.seq_len > cfg.max_decode_len and not cfg.long_context_ok:
        return False, f"architectural max context {cfg.max_decode_len}"
    return True, ""
