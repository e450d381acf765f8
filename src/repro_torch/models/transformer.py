"""Model assembly: blocks -> LM with the training loss, prefill and
slot-cache decode (the port of ``repro/models/transformer.py``).

The JAX package stacks layer parameters on a leading L axis and scans over
them; here each layer is a :class:`Block` module in an ``nn.ModuleList``,
and the functions below mirror the JAX ones with the model in place of the
parameter tree.  Blocks: ``attn_mlp`` (GQA + MLP), ``attn_moe`` (GQA +
routed MoE FFN), ``mamba2`` (one SSD mixer, no MLP) and ``hymba``
(parallel GQA and SSD heads, then an MLP).  Where the JAX block adds a
residual and then normalises, the port calls the fused residual form of
the rmsnorm kernel.

Parameters are created frozen (serving); the trainer turns their
gradients on.  With ``cfg.remat`` and a gradient wanted, each block and
each cross-entropy chunk is recomputed in the backward
(``torch.utils.checkpoint``), as the JAX package's ``jax.checkpoint``
does: the forward kernels then run twice a step.

Caches are ``{"layers": [per-layer dict], "pos": int}`` and are updated in
place by :func:`decode_step`.
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

NOT_PORTED = {
    BLOCK_MLA_MLP: "MLA attention (ROADMAP Queue 1, item 7c)",
}
ATTN_BLOCKS = (BLOCK_ATTN_MLP, BLOCK_ATTN_MOE)    # GQA then an FFN


def _check_ported(cfg: ArchConfig):
    if cfg.block in NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: block {cfg.block!r} needs {NOT_PORTED[cfg.block]},"
            f" not ported yet")
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend is not ported yet "
            f"(ROADMAP Queue 1, item 7d)")
    if cfg.block not in (*ATTN_BLOCKS, BLOCK_MAMBA2, BLOCK_HYMBA):
        raise ValueError(cfg.block)


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
        if cfg.block in (BLOCK_ATTN_MLP, BLOCK_HYMBA):
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
def _ffn(lp, h2, cfg):
    """The block's second half on the normalised h2: (y, MoE aux loss)."""
    if cfg.block == BLOCK_ATTN_MOE:
        return moe_lib.moe_forward(lp["moe"], h2, cfg)
    return mlp_forward(lp["mlp"], h2, cfg.mlp_act), None


def block_forward(lp, x, cfg, positions, want_cache=False):
    h = rms_norm(x, lp["norm1"])
    cache = None
    if cfg.block in ATTN_BLOCKS:
        y, (k, v) = attn.attention_forward(lp["attn"], h, cfg, positions)
        if want_cache:
            cache = {"k": k, "v": v}
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
    y2, aux = _ffn(lp, h2, cfg)
    return x + y2, cache, aux


def block_decode(lp, x, layer_cache, cfg):
    """One-token step; ``layer_cache`` carries 'pos' injected by the caller
    and is updated in place."""
    h = rms_norm(x, lp["norm1"])
    if cfg.block in ATTN_BLOCKS:
        y, _ = attn.attention_decode(lp["attn"], h, layer_cache, cfg)
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
    return x + _ffn(lp, h2, cfg)[0]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
class LM(nn.Module):
    """A decoder LM of one of the ported blocks, with random weights drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device`` (``None``
    means cuda; ``"meta"`` allocates nothing, for shapes)."""

    def __init__(self, cfg: ArchConfig, seed: int = 0, device=None):
        super().__init__()
        _check_ported(cfg)
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
    """Tokens only.  Returns (x (B, S, d), positions (S,))."""
    tokens = batch["tokens"]
    x = F.embedding(tokens.long(), model["embed"])
    return x, torch.arange(x.shape[1], dtype=torch.int32, device=x.device)


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
            last_only=False, unembed_out=True):
    """Returns (logits, per-layer caches or None, aux loss).  ``last_only``
    unembeds the last position alone (what prefill needs; the norm and the
    unembed are per position, so its logits equal the full run's last
    row); without ``unembed_out`` the first output is the final-normed
    hidden state.  Under ``cfg.remat``, with a gradient wanted, each block
    is recomputed in the backward."""
    x, positions = embed_inputs(model, batch, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    remat = cfg.remat and not want_cache and torch.is_grad_enabled()
    for lp in model["layers"]:
        if remat:
            x, cache, aux_i = checkpoint(block_forward, lp, x, cfg,
                                         positions, use_reentrant=False)
        else:
            x, cache, aux_i = block_forward(lp, x, cfg, positions,
                                            want_cache=want_cache)
        if aux_i is not None:
            aux = aux + aux_i
        caches.append(cache)
    if last_only:
        x = x[:, -1:]
    x = rms_norm(x, model["final_norm"])
    out = unembed(model, x, cfg) if unembed_out else x
    return out, (caches if want_cache else None), aux


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


def loss_fn(model, batch, cfg: ArchConfig):
    """(ce + 0.01 * aux, {"ce", "aux"}) on a batch {"tokens", "labels"}."""
    x, _, aux = forward(model, batch, cfg, unembed_out=False)
    ce = chunked_ce(model, x, batch["labels"], None, cfg)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None):
    """An empty cache {'layers': [per-layer dict], 'pos': 0}."""
    dev = resolve_device(device)
    _check_ported(cfg)
    dtype = getattr(torch, cfg.dtype)

    def one():
        if cfg.block == BLOCK_MAMBA2:
            return {"ssm": m2.init_mamba2_cache(cfg, batch, dtype, dev)}
        ac = attn.init_attn_cache(cfg, batch, max_len, dtype, dev)
        ac.pop("pos")
        if cfg.block in ATTN_BLOCKS:
            return ac
        return {"attn": ac, "ssm": m2.init_mamba2_cache(cfg, batch, dtype,
                                                        dev)}
    return {"layers": [one() for _ in range(cfg.n_layers)], "pos": 0}


def prefill(model, batch, cfg: ArchConfig, alloc_len: int | None = None):
    """Full-sequence prefill; returns (last-token logits (B, 1, V),
    decode-ready cache)."""
    logits, caches, _ = forward(model, batch, cfg, want_cache=True,
                                last_only=True)
    seq_len = batch["tokens"].shape[1]
    return logits, _prefill_to_cache(caches, cfg, seq_len,
                                     alloc_len or seq_len)


def _prefill_to_cache(caches, cfg, seq_len: int, alloc_len: int):
    """Per-layer prefill outputs (k, v / state) -> a decode cache.

    alloc_len: cache capacity (>= window for windowed archs).  Slot layout
    is position % capacity; the last min(seq_len, capacity) positions land
    at their slots.  One ``slot_pos`` serves the whole batch: requests in a
    batch have equal length."""
    cap = (alloc_len if cfg.sliding_window is None
           else min(alloc_len, cfg.sliding_window))
    if cfg.block == BLOCK_MAMBA2:
        return {"layers": [{"ssm": c["ssm"]} for c in caches],
                "pos": seq_len}
    kvs = [c if cfg.block in ATTN_BLOCKS else c["attn"] for c in caches]
    keep = min(seq_len, cap)
    src = torch.arange(seq_len - keep, seq_len, device=kvs[0]["k"].device)
    idx = src % cap
    sp = torch.full((cap,), -1, dtype=torch.int32, device=src.device)
    sp[idx] = src.to(torch.int32)

    def to_slots(t):                       # (B, S, ...) -> (B, cap, ...)
        out = t.new_zeros(t.shape[:1] + (cap,) + t.shape[2:])
        out[:, idx] = t[:, seq_len - keep: seq_len]
        return out

    def slots(kv):
        return {"k": to_slots(kv["k"]), "v": to_slots(kv["v"]),
                "slot_pos": sp.clone()}

    if cfg.block in ATTN_BLOCKS:
        layers = [slots(kv) for kv in kvs]
    else:
        layers = [{"attn": slots(kv), "ssm": c["ssm"]}
                  for kv, c in zip(kvs, caches)]
    return {"layers": layers, "pos": seq_len}


def decode_step(model, cache, tokens, cfg: ArchConfig):
    """tokens: (B, 1) -> (logits (B, 1, V), cache updated in place)."""
    x = model["embed"][tokens.long()]
    pos = cache["pos"]
    for lp, lc in zip(model["layers"], cache["layers"]):
        lc["pos"] = pos
        x = block_decode(lp, x, lc, cfg)
        del lc["pos"]
    x = rms_norm(x, model["final_norm"])
    cache["pos"] = pos + 1
    return unembed(model, x, cfg), cache
