"""deepseek-moe-16b [moe]: fine-grained expert segmentation + shared expert
isolation [arXiv:2401.06066; hf].  GQA attention, 2 shared + 64 routed
top-6, first layer dense."""
from .base import ArchConfig

ARCH = ArchConfig(
    name="deepseek-moe-16b", family="moe", n_layers=28, d_model=2048,
    n_heads=16, n_kv_heads=16, head_dim=128, d_ff=1408, vocab=102400,
    moe=True, n_routed=64, n_shared=2, top_k=6, d_ff_expert=1408,
    first_dense=1,
)

def smoke_config():
    return ARCH.with_overrides(n_layers=3, d_model=64, n_heads=4,
                               n_kv_heads=4, head_dim=16, d_ff=128,
                               vocab=256, n_routed=8, n_shared=1, top_k=2,
                               d_ff_expert=32)
