"""GLM-4-9B [hf:THUDM/glm-4-9b] — dense, GQA kv=2, partial RoPE."""
from repro_torch.configs.base import ArchConfig, BLOCK_ATTN_MLP, register, shrink

FULL = ArchConfig(
    name="glm4-9b", family="dense", source="hf:THUDM/glm-4-9b",
    block=BLOCK_ATTN_MLP,
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, d_head=128,
    d_ff=13696, vocab_size=151552,
    rope_theta=10_000.0, rope_fraction=0.5,
    mlp_act="silu", mlp_gated=True,
)

SMOKE = shrink(
    FULL, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
    d_ff=256, vocab_size=512, attn_chunk=64,
)

register(FULL, SMOKE)
