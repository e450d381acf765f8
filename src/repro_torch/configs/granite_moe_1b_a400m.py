"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base] —
fine-grained MoE: 32 experts, top-8, tiny per-expert FFN (512)."""
from repro_torch.configs.base import ArchConfig, BLOCK_ATTN_MOE, register, shrink

FULL = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    block=BLOCK_ATTN_MOE,
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_head=64,
    d_ff=512, vocab_size=49155,
    rope_theta=10_000.0,
    n_experts=32, top_k=8, moe_d_ff=512, capacity_factor=1.25,
    mlp_act="silu", mlp_gated=True,
)

SMOKE = shrink(
    FULL, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
    d_ff=64, moe_d_ff=64, vocab_size=512, n_experts=8, top_k=2,
    attn_chunk=64,
)

register(FULL, SMOKE)
