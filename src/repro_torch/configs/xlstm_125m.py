"""xlstm-125m [ssm]: sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].
Every 4th block is sLSTM (scalar memory); the rest are mLSTM (matrix
memory, chunk-parallel linear attention).  long_500k runs (O(1) state)."""
from .base import ArchConfig

ARCH = ArchConfig(
    name="xlstm-125m", family="ssm", n_layers=12, d_model=768,
    n_heads=4, n_kv_heads=4, head_dim=192, d_ff=0, vocab=50304,
    slstm_every=4, long_context_ok=True, gated_mlp=False,
)

def smoke_config():
    return ARCH.with_overrides(n_layers=4, d_model=64, n_heads=4,
                               n_kv_heads=4, head_dim=16, vocab=256,
                               slstm_every=2)
