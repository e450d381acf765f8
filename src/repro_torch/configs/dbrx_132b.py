"""DBRX-132B [hf:databricks/dbrx-base] — MoE 16 experts top-4, GQA kv=8."""
from repro_torch.configs.base import ArchConfig, BLOCK_ATTN_MOE, register, shrink

FULL = ArchConfig(
    name="dbrx-132b", family="moe", source="hf:databricks/dbrx-base",
    block=BLOCK_ATTN_MOE,
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=10752, vocab_size=100352,
    rope_theta=500_000.0,
    n_experts=16, top_k=4, moe_d_ff=10752, capacity_factor=1.25,
    mlp_act="silu", mlp_gated=True,
    fsdp=True, microbatches=4,
)

SMOKE = shrink(
    FULL, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
    d_ff=128, moe_d_ff=128, vocab_size=512, n_experts=4, top_k=2,
    attn_chunk=64, fsdp=False,
)

register(FULL, SMOKE)
