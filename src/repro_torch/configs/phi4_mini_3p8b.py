"""phi4-mini-3.8b [dense]: RoPE + SwiGLU + GQA(kv=8) [arXiv:2412.08905; hf]."""
from .base import ArchConfig

ARCH = ArchConfig(
    name="phi4-mini-3.8b", family="dense", n_layers=32, d_model=3072,
    n_heads=24, n_kv_heads=8, head_dim=128, d_ff=8192, vocab=200064,
)

def smoke_config():
    return ARCH.with_overrides(n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=2, head_dim=16, d_ff=128,
                               vocab=256)
