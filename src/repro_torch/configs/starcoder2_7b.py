"""StarCoder2-7B [arXiv:2402.19173] — dense GQA kv=4, sliding-window 4096.

The published config uses sliding-window attention (w=4096), which makes the
arch sub-quadratic at serve time: the long_500k cell runs with a ring cache.
"""
from repro_torch.configs.base import ArchConfig, BLOCK_ATTN_MLP, register, shrink

FULL = ArchConfig(
    name="starcoder2-7b", family="dense", source="arXiv:2402.19173",
    block=BLOCK_ATTN_MLP,
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, d_head=128,
    d_ff=18432, vocab_size=49152,
    rope_theta=100_000.0, sliding_window=4096,
    mlp_act="gelu", mlp_gated=False,
    pad_heads_to=48, fsdp=True,
)

SMOKE = shrink(
    FULL, pad_heads_to=0, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
    d_ff=256, vocab_size=512, sliding_window=32, attn_chunk=64,
)

register(FULL, SMOKE)
