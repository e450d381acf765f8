"""HuBERT-XLarge [arXiv:2106.07447] — encoder-only audio transformer.

The conv waveform frontend is a stub, as in the JAX package: ``input_specs()``
provides precomputed frame embeddings (dim 512, the conv stem's output width);
the backbone is the published 48L/1280d encoder with masked-unit prediction
over 504 k-means targets. Encoder-only: decode shapes are skipped.
"""
from repro_torch.configs.base import ArchConfig, BLOCK_ATTN_MLP, register, shrink

FULL = ArchConfig(
    name="hubert-xlarge", family="audio", source="arXiv:2106.07447",
    block=BLOCK_ATTN_MLP,
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, d_head=80,
    d_ff=5120, vocab_size=504,
    causal=False,
    frontend="audio_stub", frontend_dim=512,
    mlp_act="gelu", mlp_gated=False,
)

SMOKE = shrink(
    FULL, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_head=32,
    d_ff=256, vocab_size=64, frontend_dim=32, attn_chunk=64,
)

register(FULL, SMOKE)
