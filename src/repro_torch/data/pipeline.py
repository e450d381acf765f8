"""Deterministic synthetic data pipeline and the input shapes (the port of
``make_batch``, ``synthetic_stream`` and ``input_specs`` in
``repro/data/pipeline.py``).

Batches are drawn with numpy from the same seeds, in the same order, as
the JAX package's, so tokens, labels, audio frames and image patches are
bit-equal to it (the frontends' float inputs are drawn in float64, cast to
float32 and rounded to bfloat16, as the JAX package rounds them); they are
returned as CPU tensors (host data: the trainer moves each batch to its
device).  ``input_specs`` gives each input's shape and dtype as a tensor
on the meta device, where the JAX package gives ``jax.ShapeDtypeStruct``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeCell


def _batch_tree(cfg: ArchConfig, kind: str, seq_len: int, batch: int):
    """{name: (shape, dtype)} of a ``kind`` step's inputs."""
    t = {}
    if cfg.frontend == "audio_stub":
        t["frames"] = ((batch, seq_len, cfg.frontend_dim), torch.bfloat16)
        if kind == "train":
            t["labels"] = ((batch, seq_len), torch.int32)
        return t
    if cfg.frontend == "vision_stub" and kind in ("train", "prefill"):
        n_text = seq_len - cfg.n_patches
        t["tokens"] = ((batch, n_text), torch.int32)
        t["patch_embeds"] = ((batch, cfg.n_patches, cfg.frontend_dim),
                             torch.bfloat16)
        if kind == "train":
            t["labels"] = ((batch, n_text), torch.int32)
        return t
    if kind == "decode":
        t["tokens"] = ((batch, 1), torch.int32)
        return t
    t["tokens"] = ((batch, seq_len), torch.int32)
    if kind == "train":
        t["labels"] = ((batch, seq_len), torch.int32)
    return t


def input_specs(cfg: ArchConfig, cell: ShapeCell) -> dict:
    """{name: an empty tensor on the meta device} of the shape and dtype of
    each input of ``cell`` (allocates nothing)."""
    tree = _batch_tree(cfg, cell.kind, cell.seq_len, cell.global_batch)
    return {k: torch.empty(shape, dtype=dtype, device="meta")
            for k, (shape, dtype) in tree.items()}


# affine next-token map: t_{i+1} = (A*t_i + C) mod vocab.  A learnable
# language (the next token is a function of the current one), so train
# losses decrease below ln(vocab).
_AFF_A, _AFF_C = 31, 17


def _affine_chain(rng, batch: int, length: int, vocab: int):
    """(batch, length) token chains + the (batch, length) next-token labels."""
    toks = np.empty((batch, length + 1), np.int64)
    toks[:, 0] = rng.integers(0, vocab, batch)
    for i in range(length):
        toks[:, i + 1] = (_AFF_A * toks[:, i] + _AFF_C) % vocab
    return toks[:, :length].astype(np.int32), toks[:, 1:].astype(np.int32)


def make_batch(cfg: ArchConfig, kind: str, seq_len: int, batch: int,
               seed: int = 0) -> dict:
    """The inputs of a ``kind`` step (train, prefill or decode) as CPU
    tensors, drawn from ``np.random.default_rng(seed)``: tokens (and, for
    train, labels) from the affine chain; then, in the tree's order, the
    other integer inputs uniform over the vocabulary (audio labels) and
    the float ones standard normal (frames, patch embeddings)."""
    tree = _batch_tree(cfg, kind, seq_len, batch)
    rng = np.random.default_rng(seed)
    out = {}
    if "tokens" in tree:
        toks, labels = _affine_chain(rng, tree["tokens"][0][0],
                                     tree["tokens"][0][1], cfg.vocab_size)
        out["tokens"] = torch.from_numpy(toks)
        if "labels" in tree:
            out["labels"] = torch.from_numpy(labels)
    for k, (shape, dtype) in tree.items():
        if k in out:
            continue
        if dtype == torch.int32:
            out[k] = torch.from_numpy(
                rng.integers(0, cfg.vocab_size, shape).astype(np.int32))
        else:
            out[k] = torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32)).to(dtype)
    return out


def synthetic_stream(cfg: ArchConfig, seq_len: int, batch: int, n_steps: int,
                     seed: int = 0):
    """Deterministic stream of train batches (host-side, per-step seeds)."""
    for step in range(n_steps):
        yield make_batch(cfg, "train", seq_len, batch,
                         seed=seed * 100_003 + step)
