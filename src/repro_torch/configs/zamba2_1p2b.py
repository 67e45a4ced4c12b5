"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf].  38 Mamba2 layers, one SHARED attn+MLP block invoked
every 6 blocks (weight reuse, the Zamba signature).  long_500k runs: SSM
state is O(1); the shared attn uses a sliding window at 500k (DESIGN.md S4).
"""
from .base import ArchConfig

ARCH = ArchConfig(
    name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
    n_heads=32, n_kv_heads=32, head_dim=64, d_ff=8192, vocab=32000,
    ssm_state=64, mamba_head_dim=64, mamba_expand=2, attn_every=6,
    long_context_ok=True, long_sliding_window=4096,
)

def smoke_config():
    return ARCH.with_overrides(n_layers=4, d_model=64, n_heads=4,
                               n_kv_heads=4, head_dim=16, d_ff=128,
                               vocab=256, ssm_state=16, mamba_head_dim=16,
                               attn_every=2)
