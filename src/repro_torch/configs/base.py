"""Architecture config schema + registry (the port's own copy of
``repro.configs.base``).

Every ported architecture has one module in ``repro_torch.configs`` that
instantiates :class:`ArchConfig` with the published numbers and registers it
under its public id (``--arch <id>``).  ``SMOKE`` is a reduced config of the
same family for CPU tests; the full config is served and trained on the
card.  The sharding fields are kept so that configs compare field for field
with the JAX package's; the port reads ``remat`` and ``microbatches`` (the
trainer) and none of the others.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field, replace
from typing import Optional

BLOCK_ATTN_MLP = "attn_mlp"      # dense transformer (GQA / sliding window)
BLOCK_MLA_MLP = "mla_mlp"        # multi-head latent attention (MiniCPM3 / DeepSeek-V2 style)
BLOCK_ATTN_MOE = "attn_moe"      # GQA attention + routed MoE FFN
BLOCK_MAMBA2 = "mamba2"          # attention-free SSD block
BLOCK_HYMBA = "hymba"            # parallel attention + mamba heads (Hymba)


@dataclass(frozen=True)
class ArchConfig:
    # identity
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    source: str                  # public-literature citation tag
    block: str = BLOCK_ATTN_MLP

    # trunk
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 64
    d_ff: int = 1024
    vocab_size: int = 1024

    # attention details
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0          # fraction of d_head that is rotary (GLM4 uses 0.5)
    sliding_window: Optional[int] = None
    causal: bool = True                  # False => encoder-only (HuBERT)
    pad_heads_to: int = 0                # padded-head TP (Megatron-style):
                                         # heads padded to a mesh-divisible
                                         # count; pad heads masked inert

    # MLA (only for block == mla_mlp)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # MoE (only for block == attn_moe)
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_d_ff: int = 0                    # per-expert hidden dim (defaults to d_ff)

    # SSM (mamba2 / hymba)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # modality frontend stub
    frontend: str = "none"               # none | vision_stub | audio_stub
    frontend_dim: int = 0                # raw embedding dim delivered by the stub
    n_patches: int = 0                   # vision stub: patches per image

    # mlp flavour
    mlp_act: str = "silu"                # silu (SwiGLU) | gelu (GeGLU / plain)
    mlp_gated: bool = True
    tie_embeddings: bool = False

    # runtime policy
    fsdp: bool = False                   # ZeRO-3 style weight sharding over the data axis
    batch_over_model: bool = False       # archs whose heads can't TP: pure DP over all axes
    seq_shard: bool = True               # sequence-parallel residual stream between blocks
    remat: bool = True                   # activation checkpointing of each block
    microbatches: int = 1                # gradient-accumulation steps per update
    attn_chunk: int = 1024               # query-chunked attention block size (XLA-level flash)
    attn_scores_bf16: bool = False       # keep score tiles in bf16 (perf knob;
                                         # the Pallas flash kernel keeps f32
                                         # accum in VMEM with NO HBM score IO)
    pad_vocab_to: int = 512              # vocab padded for clean model-axis sharding
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_to
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def n_heads_padded(self) -> int:
        return max(self.n_heads, self.pad_heads_to) if self.pad_heads_to else self.n_heads

    @property
    def n_kv_heads_padded(self) -> int:
        if not self.pad_heads_to or self.n_heads == 0:
            return self.n_kv_heads
        g = max(self.n_heads // max(self.n_kv_heads, 1), 1)
        return -(-self.n_heads_padded // g)          # ceil(H_pad / G_real)

    def kv_index_map(self):
        """Static q-head -> kv-head index list under head padding."""
        g = max(self.n_heads // max(self.n_kv_heads, 1), 1)
        hp, kp = self.n_heads_padded, self.n_kv_heads_padded
        return [min(h // g, kp - 1) for h in range(hp)]

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attn_free(self) -> bool:
        return self.block == BLOCK_MAMBA2

    @property
    def sub_quadratic(self) -> bool:
        """True if serve-time cost per token is o(seq_len) state (long_500k eligible)."""
        return self.block in (BLOCK_MAMBA2, BLOCK_HYMBA) or self.sliding_window is not None

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def n_params(self) -> int:
        """Analytic parameter count (matches init; used for 6ND roofline terms)."""
        d, L = self.d_model, self.n_layers
        total = self.padded_vocab * d               # embed (padded, matches init)
        if not self.tie_embeddings:
            total += self.padded_vocab * d          # lm head
        if self.frontend != "none":
            total += self.frontend_dim * d
        per_layer = 2 * d                           # two norms
        if self.block in (BLOCK_ATTN_MLP, BLOCK_ATTN_MOE, BLOCK_HYMBA):
            per_layer += d * self.n_heads_padded * self.d_head          # wq
            per_layer += 2 * d * self.n_kv_heads_padded * self.d_head   # wk, wv
            per_layer += self.n_heads_padded * self.d_head * d          # wo
        if self.block == BLOCK_MLA_MLP:
            hp = self.n_heads_padded
            qd = self.qk_nope_head_dim + self.qk_rope_head_dim
            per_layer += d * self.q_lora_rank + self.q_lora_rank * hp * qd
            per_layer += d * (self.kv_lora_rank + self.qk_rope_head_dim)
            per_layer += self.kv_lora_rank * hp * (self.qk_nope_head_dim + self.v_head_dim)
            per_layer += hp * self.v_head_dim * d
        if self.block in (BLOCK_ATTN_MLP, BLOCK_MLA_MLP, BLOCK_HYMBA):
            mult = 3 if self.mlp_gated else 2
            per_layer += mult * d * self.d_ff
        if self.block == BLOCK_ATTN_MOE:
            mult = 3 if self.mlp_gated else 2
            per_layer += d * self.n_experts                       # router
            per_layer += self.n_experts * mult * d * self.expert_d_ff
        if self.block in (BLOCK_MAMBA2, BLOCK_HYMBA):
            di, N, H = self.d_inner, self.ssm_state, self.n_ssm_heads
            per_layer += d * (2 * di + 2 * N + H)                 # in_proj (x,z) + B,C proj + dt
            per_layer += di * self.ssm_conv_width                 # depthwise conv
            per_layer += H + H                                    # A_log, D
            per_layer += di * d                                   # out proj
            per_layer += di                                       # gated norm
        return total + L * per_layer

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only top_k experts count)."""
        if self.block != BLOCK_ATTN_MOE:
            return self.n_params()
        mult = 3 if self.mlp_gated else 2
        expert = mult * self.d_model * self.expert_d_ff
        inactive = self.n_layers * (self.n_experts - self.top_k) * expert
        return self.n_params() - inactive


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, "ArchSpec"] = {}


@dataclass(frozen=True)
class ArchSpec:
    full: ArchConfig
    smoke: ArchConfig


def register(full: ArchConfig, smoke: ArchConfig) -> ArchSpec:
    spec = ArchSpec(full=full, smoke=smoke)
    _REGISTRY[full.name] = spec
    return spec


ALL_ARCHS = [
    "glm4-9b", "minicpm3-4b", "starcoder2-7b", "granite-8b", "internvl2-26b",
    "hymba-1.5b", "dbrx-132b", "granite-moe-1b-a400m", "hubert-xlarge",
    "mamba2-130m",
]


def get_arch(name: str, smoke: bool = False) -> ArchConfig:
    if name not in _REGISTRY:
        mod = name.replace("-", "_").replace(".", "_")
        try:
            importlib.import_module(f"repro_torch.configs.{mod}")
        except ModuleNotFoundError as e:
            raise ValueError(f"{name}: no such config (the configs: "
                             f"{', '.join(ALL_ARCHS)})") from e
    spec = _REGISTRY[name]
    return spec.smoke if smoke else spec.full


def shrink(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Helper to derive the reduced smoke config from the full config."""
    return replace(cfg, **overrides)


# ---------------------------------------------------------------------------
# assigned input shapes (same four cells for every LM arch)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}


def cell_applicable(cfg: ArchConfig, shape: ShapeCell) -> tuple[bool, str]:
    """Whether (arch x shape) is a valid dry-run cell, per the task spec."""
    if shape.kind == "decode" and cfg.is_encoder:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: 500k decode needs sub-quadratic attention"
    return True, ""
