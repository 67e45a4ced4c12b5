"""internvl2-26b [vlm]: InternViT frontend (STUB: precomputed patch
embeddings) + InternLM2-style 48L backbone [arXiv:2404.16821; hf]."""
from .base import ArchConfig

ARCH = ArchConfig(
    name="internvl2-26b", family="vlm", n_layers=48, d_model=6144,
    n_heads=48, n_kv_heads=8, head_dim=128, d_ff=16384, vocab=92553,
    prefix_len=256,
)

def smoke_config():
    return ARCH.with_overrides(n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=2, head_dim=16, d_ff=128,
                               vocab=257, prefix_len=4)
