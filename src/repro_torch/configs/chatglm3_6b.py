"""chatglm3-6b [dense]: 2d RoPE (half-dim rotary), GQA kv=2, QKV bias
[arXiv:2406.12793; hf]."""
from .base import ArchConfig

ARCH = ArchConfig(
    name="chatglm3-6b", family="dense", n_layers=28, d_model=4096,
    n_heads=32, n_kv_heads=2, head_dim=128, d_ff=13696, vocab=65024,
    rotary_frac=0.5, attn_bias=True,
)

def smoke_config():
    return ARCH.with_overrides(n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=2, head_dim=16, d_ff=128,
                               vocab=256)
