"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B] — dense with MLA (latent KV)."""
from repro_torch.configs.base import ArchConfig, BLOCK_MLA_MLP, register, shrink

FULL = ArchConfig(
    name="minicpm3-4b", family="dense", source="hf:openbmb/MiniCPM3-4B",
    block=BLOCK_MLA_MLP,
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, d_head=96,
    d_ff=6400, vocab_size=73448,
    q_lora_rank=768, kv_lora_rank=256,
    qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64,
    rope_theta=10_000.0,
    mlp_act="silu", mlp_gated=True,
    pad_heads_to=48, fsdp=True,
)

SMOKE = shrink(
    FULL, pad_heads_to=0, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab_size=512, q_lora_rank=48, kv_lora_rank=32,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, attn_chunk=64,
)

register(FULL, SMOKE)
