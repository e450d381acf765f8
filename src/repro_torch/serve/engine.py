"""Batched serving engine: prefill, then decode with the slot cache (the
port of ``repro/serve/engine.py``).

Maps STAR's serving story: the model replica serves reads while training
epochs commit elsewhere; ``load_params`` swaps in a newer committed epoch
under the Thomas write rule between requests.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf


@dataclass
class ServeStats:
    prefill_tokens: int = 0
    decoded_tokens: int = 0
    param_swaps: int = 0
    # host clock around work that ends in a device synchronise
    prefill_s: float = 0.0
    decode_s: float = 0.0
    decode_steps: int = 0


class ServeEngine:
    """``model`` is a :class:`repro_torch.models.transformer.LM`; it is
    moved to ``device`` (``None`` means cuda, which must be present).
    ``mesh``: a ``launch.mesh.Mesh`` whose ``model`` axis runs the MoE
    layers expert-parallel (every rank generates the same tokens)."""

    def __init__(self, cfg: ArchConfig, model, device=None,
                 max_len: int = 512, mesh=None):
        self.device = resolve_device(device)
        self.cfg, self.max_len, self.mesh = cfg, max_len, mesh
        self.model = model.to(self.device)
        self.params_tid = 0
        self.stats = ServeStats()

    def load_params(self, params, tid: int):
        """Thomas-rule swap: only a strictly newer committed epoch applies.
        ``params`` is a state dict of the model (``convert.params_from_jax``
        or ``LM.state_dict()``)."""
        if tid > self.params_tid:
            self.model.load_state_dict(params)
            self.params_tid = tid
            self.stats.param_swaps += 1
            return True
        return False

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def generate(self, prompts, n_tokens: int, greedy: bool = True,
                 generator: torch.Generator | None = None):
        """prompts: (B, S) int -> (B, n_tokens) int32.  The first token is
        the prefill's argmax; then each of ``n_tokens`` decode steps picks
        the next one, greedily or by sampling from ``generator``."""
        cfg = self.cfg
        B, S = prompts.shape
        t0 = time.perf_counter()
        logits, cache = tf.prefill(self.model,
                                   {"tokens": prompts.to(self.device)}, cfg,
                                   alloc_len=self.max_len, mesh=self.mesh)
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        self._sync()
        t1 = time.perf_counter()
        self.stats.prefill_s += t1 - t0
        self.stats.prefill_tokens += B * S
        outs = []
        for _ in range(n_tokens):
            outs.append(tok)
            logits, cache = tf.decode_step(self.model, cache, tok, cfg,
                                           mesh=self.mesh)
            if greedy:
                tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            else:
                probs = torch.softmax(logits[:, -1].float(), dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator).to(
                    torch.int32)
            self.stats.decoded_tokens += B
        self._sync()
        self.stats.decode_s += time.perf_counter() - t1
        self.stats.decode_steps += n_tokens
        if not outs:
            return torch.empty((B, 0), dtype=torch.int32, device=self.device)
        return torch.cat(outs, dim=1)
