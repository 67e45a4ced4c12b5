"""internlm2-1.8b [dense]: GQA kv=8 [arXiv:2403.17297; hf]."""
from .base import ArchConfig

ARCH = ArchConfig(
    name="internlm2-1.8b", family="dense", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=8, head_dim=128, d_ff=8192, vocab=92544,
)

def smoke_config():
    return ARCH.with_overrides(n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=2, head_dim=16, d_ff=128,
                               vocab=256)
