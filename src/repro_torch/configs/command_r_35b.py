"""command-r-35b [dense]: GQA(kv=8), no biases
[hf:CohereForAI/c4ai-command-r-v01; unverified]."""
from .base import ArchConfig

ARCH = ArchConfig(
    name="command-r-35b", family="dense", n_layers=40, d_model=8192,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=22528, vocab=256000,
    attn_bias=False,
)

def smoke_config():
    return ARCH.with_overrides(n_layers=2, d_model=64, n_heads=8,
                               n_kv_heads=2, head_dim=16, d_ff=160,
                               vocab=256)
