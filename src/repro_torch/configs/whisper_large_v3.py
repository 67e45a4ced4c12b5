"""whisper-large-v3 [audio]: encoder-decoder; conv frontend STUB --
input_specs() provides precomputed 1500-frame embeddings
[arXiv:2212.04356; unverified].  Sinusoidal positions (no RoPE), LayerNorm,
plain GELU MLP, attention biases; architectural max decode context 448,
so decode shapes lower structurally with the full requested cache and the
long_500k cell is skipped (DESIGN.md S4)."""
from .base import ArchConfig

ARCH = ArchConfig(
    name="whisper-large-v3", family="audio", n_layers=32, d_model=1280,
    n_heads=20, n_kv_heads=20, head_dim=64, d_ff=5120, vocab=51866,
    norm="layer", gated_mlp=False, act="gelu", attn_bias=True,
    enc_layers=32, enc_seq=1500, use_rope=False, max_decode_len=448,
)

def smoke_config():
    return ARCH.with_overrides(n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=4, head_dim=16, d_ff=128,
                               vocab=256, enc_layers=2, enc_seq=8)
