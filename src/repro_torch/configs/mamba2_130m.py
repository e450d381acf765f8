"""Mamba2-130M [arXiv:2405.21060] — attention-free SSD (state-space duality)."""
from repro_torch.configs.base import ArchConfig, BLOCK_MAMBA2, register, shrink

FULL = ArchConfig(
    name="mamba2-130m", family="ssm", source="arXiv:2405.21060",
    block=BLOCK_MAMBA2,
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_head=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv_width=4,
    ssm_chunk=256,
    batch_over_model=True,
)

SMOKE = shrink(
    FULL, n_layers=2, d_model=64, vocab_size=512,
    ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
)

register(FULL, SMOKE)
