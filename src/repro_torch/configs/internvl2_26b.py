"""InternVL2-26B [arXiv:2404.16821] — VLM: InternViT frontend (stub) +
InternLM2-20B backbone (48L, d=6144, 48H GQA kv=8).

The modality frontend is a stub, as in the JAX package: ``input_specs()`` supplies
precomputed patch embeddings (InternViT-6B hidden size 3200); the framework
projects them into the LM embedding space and runs the published backbone.
"""
from repro_torch.configs.base import ArchConfig, BLOCK_ATTN_MLP, register, shrink

FULL = ArchConfig(
    name="internvl2-26b", family="vlm", source="arXiv:2404.16821",
    block=BLOCK_ATTN_MLP,
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=16384, vocab_size=92553,
    rope_theta=1_000_000.0,
    frontend="vision_stub", frontend_dim=3200, n_patches=256,
    mlp_act="silu", mlp_gated=True,
    fsdp=True, microbatches=2,
)

SMOKE = shrink(
    FULL, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
    d_ff=256, vocab_size=512, frontend_dim=64, n_patches=8, attn_chunk=64,
    fsdp=False,
)

register(FULL, SMOKE)
