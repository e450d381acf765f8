"""Deterministic synthetic data pipeline (the port of ``make_batch`` and
``synthetic_stream`` in ``repro/data/pipeline.py``).

Batches are drawn with numpy from the same seeds as the JAX package's, so
tokens and labels are bit-equal to it; they are returned as CPU tensors
(host data: the trainer moves each batch to its device).  The frontends'
inputs (audio frames, image patches) wait for the frontends (ROADMAP
Queue 1, item 7d).  ``input_specs``, the dry-run's shape stand-ins, has no
counterpart: the port lowers nothing ahead of time.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


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
    """{"tokens"} (decode: one token a row; prefill: seq_len) or, for
    train, {"tokens", "labels"} as int32 CPU tensors, drawn from
    ``np.random.default_rng(seed)``."""
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend's inputs are not "
            f"ported yet (ROADMAP Queue 1, item 7d)")
    rng = np.random.default_rng(seed)
    toks, labels = _affine_chain(rng, batch, 1 if kind == "decode"
                                 else seq_len, cfg.vocab_size)
    out = {"tokens": torch.from_numpy(toks)}
    if kind == "train":
        out["labels"] = torch.from_numpy(labels)
    return out


def synthetic_stream(cfg: ArchConfig, seq_len: int, batch: int, n_steps: int,
                     seed: int = 0):
    """Deterministic stream of train batches (host-side, per-step seeds)."""
    for step in range(n_steps):
        yield make_batch(cfg, "train", seq_len, batch,
                         seed=seed * 100_003 + step)
