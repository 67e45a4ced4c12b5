"""deepseek-v2-lite-16b [moe]: MLA (kv_lora=512) + fine-grained MoE
[arXiv:2405.04434; hf].  2 shared + 64 routed experts, top-6 (the task
header says "MoE 64e top-6"; the inline "160 routed" matches full V2, not
Lite -- we follow the 64e header; see DESIGN.md S4)."""
from .base import ArchConfig

ARCH = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe", n_layers=27, d_model=2048,
    n_heads=16, n_kv_heads=16, head_dim=128, d_ff=1408, vocab=102400,
    moe=True, n_routed=64, n_shared=2, top_k=6, d_ff_expert=1408,
    first_dense=1, mla=True, kv_lora=512, qk_nope=128, qk_rope=64,
)

def smoke_config():
    return ARCH.with_overrides(n_layers=3, d_model=64, n_heads=4,
                               n_kv_heads=4, head_dim=16, d_ff=128,
                               vocab=256, n_routed=8, n_shared=1, top_k=2,
                               d_ff_expert=32, kv_lora=32, qk_nope=16,
                               qk_rope=8)
