"""Hymba-1.5B [arXiv:2411.13676] — hybrid: parallel attention + mamba heads.

Published model mixes SWA layers with a few global-attention layers; we run
all layers with SWA (w=1024) + parallel SSM heads — noted in DESIGN.md — which
keeps the arch sub-quadratic so long_500k runs.
"""
from repro_torch.configs.base import ArchConfig, BLOCK_HYMBA, register, shrink

FULL = ArchConfig(
    name="hymba-1.5b", family="hybrid", source="arXiv:2411.13676",
    block=BLOCK_HYMBA,
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_head=64,
    d_ff=5504, vocab_size=32001,
    rope_theta=10_000.0, sliding_window=1024,
    ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_conv_width=4,
    mlp_act="silu", mlp_gated=True,
    pad_heads_to=32,
)

SMOKE = shrink(
    FULL, pad_heads_to=0, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
    d_ff=256, vocab_size=512, sliding_window=32,
    ssm_state=8, ssm_head_dim=32, ssm_chunk=16, attn_chunk=64,
)

register(FULL, SMOKE)
