"""Granite-8B code [arXiv:2405.04324] — llama-arch dense, GQA kv=8."""
from repro_torch.configs.base import ArchConfig, BLOCK_ATTN_MLP, register, shrink

FULL = ArchConfig(
    name="granite-8b", family="dense", source="arXiv:2405.04324",
    block=BLOCK_ATTN_MLP,
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab_size=49152,
    rope_theta=10_000_000.0,
    mlp_act="silu", mlp_gated=True,
)

SMOKE = shrink(
    FULL, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
    d_ff=256, vocab_size=512, attn_chunk=64,
)

register(FULL, SMOKE)
