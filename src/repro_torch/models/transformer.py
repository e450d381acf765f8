"""Model assembly: blocks -> LM with the training loss, prefill and
slot-cache decode (the port of ``repro/models/transformer.py``).

The JAX package stacks layer parameters on a leading L axis and scans over
them; here each layer is a :class:`Block` module in an ``nn.ModuleList``,
and the functions below mirror the JAX ones with the model in place of the
parameter tree.  Blocks: ``attn_mlp`` (GQA + MLP), ``mla_mlp`` (MLA +
MLP), ``attn_moe`` (GQA + routed MoE FFN), ``mamba2`` (one SSD mixer, no
MLP) and ``hymba`` (parallel GQA and SSD heads, then an MLP).  Where the
JAX block adds a residual and then normalises, the port calls the fused
residual form of the rmsnorm kernel.  The modality frontends are the JAX
package's stubs: ``audio_stub`` projects precomputed frames (HuBERT),
``vision_stub`` projects precomputed patch embeddings and puts them
before the tokens (InternVL2), the loss then taken on the text alone.

Parameters are created frozen (serving); the trainer turns their
gradients on.  With ``cfg.remat`` and a gradient wanted, each block and
each cross-entropy chunk is recomputed in the backward
(``torch.utils.checkpoint``), as the JAX package's ``jax.checkpoint``
does: the forward kernels then run twice a step.

Caches are ``{"layers": [per-layer dict], "pos": int}`` and are updated in
place by :func:`decode_step`.

``mesh=`` passes through ``block_forward``, ``block_decode``, ``forward``,
``loss_fn``, ``prefill`` and ``decode_step`` as in the JAX signatures; it
reaches only the MoE layers (``moe.moe_forward``'s expert-parallel
branch).  The reference's ``_seq_constraint`` has no counterpart: it is a
layout hint to GSPMD that leaves every value unchanged, and the port's
dense layers are not split over ``model`` (``train/trainer.py``).
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ArchConfig, BLOCK_ATTN_MLP,
                                      BLOCK_ATTN_MOE, BLOCK_HYMBA,
                                      BLOCK_MAMBA2, BLOCK_MLA_MLP)
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (const_init, cross_entropy, init_mlp,
                                       mlp_forward, normal_init, rms_norm)

ATTN_BLOCKS = (BLOCK_ATTN_MLP, BLOCK_ATTN_MOE)    # GQA then an FFN
BLOCKS = (*ATTN_BLOCKS, BLOCK_MLA_MLP, BLOCK_MAMBA2, BLOCK_HYMBA)
FRONTENDS = ("none", "audio_stub", "vision_stub")


def _check_config(cfg: ArchConfig):
    if cfg.block not in BLOCKS:
        raise ValueError(f"{cfg.name}: no block {cfg.block!r}; the blocks "
                         f"are {BLOCKS}")
    if cfg.frontend not in FRONTENDS:
        raise ValueError(f"{cfg.name}: no frontend {cfg.frontend!r}; the "
                         f"frontends are {FRONTENDS}")


def _frozen(t):
    return nn.Parameter(t, requires_grad=False)


def _params(d: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: _frozen(v) for k, v in d.items()})


# ---------------------------------------------------------------------------
# per-layer module
# ---------------------------------------------------------------------------
class Block(nn.Module):
    """One layer's parameters, named as in the JAX tree (``norm1``,
    ``attn.wq``, ``ssm.in_proj``, ``mlp.w_up``, ...).  ``lp["name"]``
    reads a parameter or a sub-dict, as the JAX code indexes its tree."""

    def __init__(self, cfg: ArchConfig, gen, dtype):
        super().__init__()
        d = cfg.d_model
        self.norm1 = _frozen(const_init(gen, (d,), 1.0, dtype))
        if cfg.block != BLOCK_MAMBA2:   # mamba2-130m: one mixer, no MLP
            self.norm2 = _frozen(const_init(gen, (d,), 1.0, dtype))
        if cfg.block in (*ATTN_BLOCKS, BLOCK_HYMBA):
            self.attn = _params(attn.init_attention(gen, cfg, dtype))
        if cfg.block == BLOCK_MLA_MLP:
            self.attn = _params(attn.init_mla(gen, cfg, dtype))
        if cfg.block in (BLOCK_ATTN_MLP, BLOCK_MLA_MLP, BLOCK_HYMBA):
            self.mlp = _params(init_mlp(gen, d, cfg.d_ff, cfg.mlp_gated,
                                        dtype))
        if cfg.block == BLOCK_ATTN_MOE:
            self.moe = _params(moe_lib.init_moe(gen, cfg, dtype))
        if cfg.block in (BLOCK_MAMBA2, BLOCK_HYMBA):
            self.ssm = _params(m2.init_mamba2(gen, cfg, dtype))
        if cfg.block == BLOCK_HYMBA:
            self.attn_norm = _frozen(const_init(gen, (d,), 1.0, dtype))
            self.ssm_norm = _frozen(const_init(gen, (d,), 1.0, dtype))

    def __getitem__(self, name):
        return getattr(self, name)


# ---------------------------------------------------------------------------
# blocks (full-sequence form).  Return (x, per-layer cache or None, aux)
# ---------------------------------------------------------------------------
def _ffn(lp, h2, cfg, mesh=None):
    """The block's second half on the normalised h2: (y, MoE aux loss)."""
    if cfg.block == BLOCK_ATTN_MOE:
        return moe_lib.moe_forward(lp["moe"], h2, cfg, mesh=mesh)
    return mlp_forward(lp["mlp"], h2, cfg.mlp_act), None


def block_forward(lp, x, cfg, positions, want_cache=False, mesh=None):
    h = rms_norm(x, lp["norm1"])
    cache = None
    if cfg.block in ATTN_BLOCKS:
        y, (k, v) = attn.attention_forward(lp["attn"], h, cfg, positions)
        if want_cache:
            cache = {"k": k, "v": v}
    elif cfg.block == BLOCK_MLA_MLP:
        y, (c_kv, k_rope) = attn.mla_forward(lp["attn"], h, cfg, positions)
        if want_cache:
            cache = {"c_kv": c_kv, "k_rope": k_rope}
    elif cfg.block == BLOCK_MAMBA2:
        y, state = m2.mamba2_forward(lp["ssm"], h, cfg,
                                     return_state=want_cache)
        if want_cache:
            cache = {"ssm": state}
        return x + y, cache, None       # single-mixer block: no MLP half
    else:                               # hymba
        ya, (k, v) = attn.attention_forward(lp["attn"], h, cfg, positions)
        ys, state = m2.mamba2_forward(lp["ssm"], h, cfg,
                                      return_state=want_cache)
        y = 0.5 * (rms_norm(ya, lp["attn_norm"])
                   + rms_norm(ys, lp["ssm_norm"]))
        if want_cache:
            cache = {"attn": {"k": k, "v": v}, "ssm": state}
    h2, x = rms_norm(y, lp["norm2"], residual=x)      # x + y, then norm
    y2, aux = _ffn(lp, h2, cfg, mesh)
    return x + y2, cache, aux


def block_decode(lp, x, layer_cache, cfg, mesh=None):
    """One-token step; ``layer_cache`` carries 'pos' injected by the caller
    and is updated in place."""
    h = rms_norm(x, lp["norm1"])
    if cfg.block in ATTN_BLOCKS:
        y, _ = attn.attention_decode(lp["attn"], h, layer_cache, cfg)
    elif cfg.block == BLOCK_MLA_MLP:
        y, _ = attn.mla_decode(lp["attn"], h, layer_cache, cfg)
    elif cfg.block == BLOCK_MAMBA2:
        y, layer_cache["ssm"] = m2.mamba2_decode(lp["ssm"], h,
                                                 layer_cache["ssm"], cfg)
        return x + y
    else:                               # hymba
        ac = layer_cache["attn"]
        ac["pos"] = layer_cache["pos"]
        ya, _ = attn.attention_decode(lp["attn"], h, ac, cfg)
        del ac["pos"]
        ys, layer_cache["ssm"] = m2.mamba2_decode(lp["ssm"], h,
                                                  layer_cache["ssm"], cfg)
        y = 0.5 * (rms_norm(ya, lp["attn_norm"])
                   + rms_norm(ys, lp["ssm_norm"]))
    h2, x = rms_norm(y, lp["norm2"], residual=x)      # x + y, then norm
    return x + _ffn(lp, h2, cfg, mesh)[0]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
class LM(nn.Module):
    """An LM of one of the blocks (an encoder where ``cfg.causal`` is
    False), with random weights drawn from a ``torch.Generator`` seeded
    with ``seed`` on ``device`` (``None`` means cuda; ``"meta"`` allocates
    nothing, for shapes).  A frontend adds ``frontend.proj``
    (frontend_dim, d)."""

    def __init__(self, cfg: ArchConfig, seed: int = 0, device=None):
        super().__init__()
        _check_config(cfg)
        self.cfg = cfg
        dev = resolve_device(device)
        gen = (None if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(seed))
        dtype = getattr(torch, cfg.dtype)
        d = cfg.d_model
        self.embed = _frozen(normal_init(gen, (cfg.padded_vocab, d),
                                         d ** -0.5, dtype))
        self.final_norm = _frozen(const_init(gen, (d,), 1.0, dtype))
        if not cfg.tie_embeddings:
            self.lm_head = _frozen(normal_init(gen, (d, cfg.padded_vocab),
                                               d ** -0.5, dtype))
        if cfg.frontend != "none":
            self.frontend = _params({"proj": normal_init(
                gen, (cfg.frontend_dim, d), cfg.frontend_dim ** -0.5,
                dtype)})
        self.layers = nn.ModuleList(Block(cfg, gen, dtype)
                                    for _ in range(cfg.n_layers))

    def __getitem__(self, name):
        return getattr(self, name)


def param_shapes(cfg: ArchConfig) -> dict:
    """{state-dict name: (shape, dtype)} of the model of ``cfg``."""
    return {k: (tuple(v.shape), v.dtype)
            for k, v in LM(cfg, device="meta").state_dict().items()}


# ---------------------------------------------------------------------------
# embedding
# ---------------------------------------------------------------------------
def embed_inputs(model, batch, cfg: ArchConfig):
    """Returns (x (B, S, d), positions (S,), loss mask (B, S) or None).
    ``audio_stub``: x is ``batch["frames"]`` (B, T, frontend_dim) through
    the projection.  ``vision_stub`` with ``batch["patch_embeds"]`` (B, P,
    frontend_dim): the projected patches, then the token embeddings, and
    a mask of 0 on the patches and 1 on the text; without patches, tokens
    only."""
    mask = None
    if cfg.frontend == "audio_stub":
        x = batch["frames"].to(model["embed"].dtype) @ model["frontend"][
            "proj"]
    else:
        tokens = batch["tokens"]
        x = F.embedding(tokens.long(), model["embed"])
        if cfg.frontend == "vision_stub" and "patch_embeds" in batch:
            pe = (batch["patch_embeds"].to(x.dtype)
                  @ model["frontend"]["proj"])
            x = torch.cat([pe, x], dim=1)
            B, n_patch = pe.shape[:2]
            mask = torch.cat(
                [torch.zeros((B, n_patch), dtype=torch.float32,
                             device=x.device),
                 torch.ones((B, tokens.shape[1]), dtype=torch.float32,
                            device=x.device)], dim=1)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    return x, positions, mask


def input_len(batch, cfg: ArchConfig) -> int:
    """The positions ``batch`` fills: frames, or patches and tokens."""
    if cfg.frontend == "audio_stub":
        return batch["frames"].shape[1]
    n = batch["tokens"].shape[1]
    if cfg.frontend == "vision_stub" and "patch_embeds" in batch:
        n += batch["patch_embeds"].shape[1]
    return n


def unreached_params(cfg: ArchConfig) -> set:
    """The parameters ``loss_fn`` never reads: an audio encoder's token
    embedding, unless it is tied to the unembedding."""
    return ({"embed"} if cfg.frontend == "audio_stub"
            and not cfg.tie_embeddings else set())


def unembed(model, x, cfg):
    w = model["embed"].T if cfg.tie_embeddings else model["lm_head"]
    logits = x @ w
    if cfg.padded_vocab != cfg.vocab_size:                 # mask pad rows
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------
def forward(model, batch, cfg: ArchConfig, want_cache=False,
            last_only=False, unembed_out=True, mesh=None):
    """Returns (logits, per-layer caches or None, aux loss, loss mask or
    None: :func:`embed_inputs`'s).  ``last_only``
    unembeds the last position alone (what prefill needs; the norm and the
    unembed are per position, so its logits equal the full run's last
    row); without ``unembed_out`` the first output is the final-normed
    hidden state.  Under ``cfg.remat``, with a gradient wanted, each block
    is recomputed in the backward."""
    x, positions, mask = embed_inputs(model, batch, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    remat = cfg.remat and not want_cache and torch.is_grad_enabled()
    for lp in model["layers"]:
        if remat:
            x, cache, aux_i = checkpoint(block_forward, lp, x, cfg,
                                         positions, False, mesh,
                                         use_reentrant=False)
        else:
            x, cache, aux_i = block_forward(lp, x, cfg, positions,
                                            want_cache=want_cache, mesh=mesh)
        if aux_i is not None:
            aux = aux + aux_i
        caches.append(cache)
    if last_only:
        x = x[:, -1:]
    x = rms_norm(x, model["final_norm"])
    out = unembed(model, x, cfg) if unembed_out else x
    return out, (caches if want_cache else None), aux, mask


def _ce_chunk(model, cfg, x, labels, mask):
    """One chunk of :func:`chunked_ce`: (sum of masked nll, mask sum)."""
    logits = unembed(model, x, cfg).float()
    m = logits.max(dim=-1, keepdim=True).values.detach()
    lse = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]
    lab = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return ((lse - lab) * mask).sum(), mask.sum()


def chunked_ce(model, x, labels, mask, cfg: ArchConfig, chunk: int = 512):
    """Sequence-chunked fused unembed + CE: the (B, S, V) logits are never
    all materialized; each (B, chunk, V) tile is computed, reduced and,
    with a gradient wanted, recomputed in the backward."""
    B, S, _ = x.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    if S % chunk != 0 or S <= chunk:
        return cross_entropy(unembed(model, x, cfg), labels, mask)
    one = partial(_ce_chunk, model, cfg)
    nll = cnt = 0.0
    for i in range(S // chunk):
        part = (x[:, i * chunk:(i + 1) * chunk],
                labels[:, i * chunk:(i + 1) * chunk],
                mask[:, i * chunk:(i + 1) * chunk])
        n, c = (checkpoint(one, *part, use_reentrant=False)
                if torch.is_grad_enabled() else one(*part))
        nll, cnt = nll + n, cnt + c
    return nll / torch.clamp(cnt, min=1.0)


def loss_fn(model, batch, cfg: ArchConfig, mesh=None):
    """(ce + 0.01 * aux, {"ce", "aux"}) on a train batch (``make_batch``'s:
    tokens, frames or tokens and patches, and labels).  With patches the
    loss is on the text positions alone: the hidden state of the patches
    is dropped before the CE, as the JAX ``loss_fn`` drops it."""
    x, _, aux, mask = forward(model, batch, cfg, unembed_out=False,
                              mesh=mesh)
    labels = batch["labels"]
    if mask is not None:
        n_patch = x.shape[1] - labels.shape[1]
        x, mask = x[:, n_patch:], mask[:, n_patch:]
    ce = chunked_ce(model, x, labels, mask, cfg)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None):
    """An empty cache {'layers': [per-layer dict], 'pos': 0}."""
    dev = resolve_device(device)
    _check_config(cfg)
    dtype = getattr(torch, cfg.dtype)

    def one():
        if cfg.block == BLOCK_MAMBA2:
            return {"ssm": m2.init_mamba2_cache(cfg, batch, dtype, dev)}
        if cfg.block == BLOCK_MLA_MLP:
            c = attn.init_mla_cache(cfg, batch, max_len, dtype, dev)
            c.pop("pos")
            return c
        ac = attn.init_attn_cache(cfg, batch, max_len, dtype, dev)
        ac.pop("pos")
        if cfg.block in ATTN_BLOCKS:
            return ac
        return {"attn": ac, "ssm": m2.init_mamba2_cache(cfg, batch, dtype,
                                                        dev)}
    return {"layers": [one() for _ in range(cfg.n_layers)], "pos": 0}


def prefill(model, batch, cfg: ArchConfig, alloc_len: int | None = None,
            mesh=None):
    """Full-sequence prefill; returns (last-token logits (B, 1, V),
    decode-ready cache).  With patches (``vision_stub``) the positions
    count them: decode starts after the patches and the prompt."""
    logits, caches, _, _ = forward(model, batch, cfg, want_cache=True,
                                   last_only=True, mesh=mesh)
    seq_len = input_len(batch, cfg)
    return logits, _prefill_to_cache(caches, cfg, seq_len,
                                     alloc_len or seq_len)


def _prefill_to_cache(caches, cfg, seq_len: int, alloc_len: int):
    """Per-layer prefill outputs (k, v / latent / state) -> a decode
    cache.

    alloc_len: cache capacity (>= window for windowed archs).  Slot layout
    is position % capacity; the last min(seq_len, capacity) positions land
    at their slots.  One ``slot_pos`` serves the whole batch: requests in a
    batch have equal length."""
    cap = (alloc_len if cfg.sliding_window is None
           else min(alloc_len, cfg.sliding_window))
    if cfg.block == BLOCK_MAMBA2:
        return {"layers": [{"ssm": c["ssm"]} for c in caches],
                "pos": seq_len}
    kvs = [c["attn"] if cfg.block == BLOCK_HYMBA else c for c in caches]
    keep = min(seq_len, cap)
    src = torch.arange(seq_len - keep, seq_len,
                       device=next(iter(kvs[0].values())).device)
    idx = src % cap
    sp = torch.full((cap,), -1, dtype=torch.int32, device=src.device)
    sp[idx] = src.to(torch.int32)

    def to_slots(t):                       # (B, S, ...) -> (B, cap, ...)
        out = t.new_zeros(t.shape[:1] + (cap,) + t.shape[2:])
        out[:, idx] = t[:, seq_len - keep: seq_len]
        return out

    def slots(kv):
        return {**{k: to_slots(t) for k, t in kv.items()},
                "slot_pos": sp.clone()}

    if cfg.block in (*ATTN_BLOCKS, BLOCK_MLA_MLP):
        layers = [slots(kv) for kv in kvs]
    else:
        layers = [{"attn": slots(kv), "ssm": c["ssm"]}
                  for kv, c in zip(kvs, caches)]
    return {"layers": layers, "pos": seq_len}


def decode_step(model, cache, tokens, cfg: ArchConfig, mesh=None):
    """tokens: (B, 1) -> (logits (B, 1, V), cache updated in place)."""
    x = model["embed"][tokens.long()]
    pos = cache["pos"]
    for lp, lc in zip(model["layers"], cache["layers"]):
        lc["pos"] = pos
        x = block_decode(lp, x, lc, cfg, mesh)
        del lc["pos"]
    x = rms_norm(x, model["final_norm"])
    cache["pos"] = pos + 1
    return unembed(model, x, cfg), cache


def keep_local_experts(model, mesh):
    """Drop every expert but this rank's from ``model``'s MoE layers
    (expert-parallel serving: a rank holds ``n_experts / model`` experts
    a layer).  A no-op off an expert-parallel mesh."""
    cfg = model.cfg
    if cfg.block != BLOCK_ATTN_MOE or not moe_lib.expert_parallel(cfg, mesh):
        return model
    for blk in model.layers:
        loc = moe_lib.local_experts(dict(blk.moe.items()), cfg, mesh)
        for k, v in loc.items():
            if k != "router":
                blk.moe[k] = nn.Parameter(v.detach().clone(),
                                          requires_grad=v.requires_grad)
    return model
