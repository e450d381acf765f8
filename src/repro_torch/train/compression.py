"""Gradient compression for the cross-pod replication stream (the port of
``repro/train/compression.py``).

STAR's hybrid replication insight (ship the cheap representation when the
stream's structure allows it, §5) applied to the gradient all-reduce.
Two codecs with error feedback (residual carrying):

* ``topk``: operation-style, ship (indices, values) of the largest-|g|
  fraction of each tensor (``torch.topk`` may order equal magnitudes
  otherwise than ``lax.top_k``);
* ``int8``: value-style, per-tensor affine quantization.

``CompressedAllReduce`` owns the error-feedback state and reports the
bytes shipped against dense, in one process (no collective yet).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


def topk_encode(g, frac: float = 0.01):
    """Returns (idx int32, vals, shape) for the top-|g| fraction."""
    flat = g.reshape(-1)
    k = max(1, int(flat.numel() * frac))
    _, idx = torch.topk(flat.abs(), k)
    return idx.to(torch.int32), flat[idx], tuple(g.shape)


def topk_decode(idx, vals, shape, dtype):
    n = 1
    for s in shape:
        n *= s
    flat = torch.zeros(n, dtype=dtype, device=vals.device)
    flat[idx.long()] = vals.to(dtype)
    return flat.reshape(shape)


def int8_encode(g):
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decode(q, scale, dtype):
    return (q.float() * scale).to(dtype)


@dataclass
class CompressionStats:
    dense_bytes: int = 0
    shipped_bytes: int = 0

    @property
    def ratio(self) -> float:
        return self.dense_bytes / max(self.shipped_bytes, 1)


class CompressedAllReduce:
    """Error-feedback compressor for a gradient dict {name: tensor}."""

    def __init__(self, codec: str = "topk", frac: float = 0.01):
        if codec not in ("topk", "int8", "none"):
            raise ValueError(f"unknown codec {codec!r}")
        self.codec, self.frac = codec, frac
        self.residual = None
        self.stats = CompressionStats()

    def __call__(self, grads: dict) -> dict:
        """Compress and decompress (the lossy channel) with error
        feedback.  Returns the gradient actually applied; on several pods
        the compressed form is what would be all-reduced."""
        if self.codec == "none":
            return grads
        if self.residual is None:
            self.residual = {k: torch.zeros(g.shape, dtype=torch.float32,
                                            device=g.device)
                             for k, g in grads.items()}
        out = {}
        for k, g in grads.items():
            acc = g.float() + self.residual[k]
            nbytes = acc.numel() * g.element_size()
            if self.codec == "topk":
                idx, vals, shape = topk_encode(acc, self.frac)
                sent = topk_decode(idx, vals, shape, torch.float32)
                self.stats.shipped_bytes += int(idx.numel() * (4 + 4))
            else:
                q, scale = int8_encode(acc)
                sent = int8_decode(q, scale, torch.float32)
                self.stats.shipped_bytes += int(q.numel() + 4)
            self.stats.dense_bytes += int(nbytes)
            self.residual[k] = acc - sent
            out[k] = sent.to(g.dtype)
        return out
