"""The training step (the port of ``make_train_fn`` in
``repro/launch/steps.py``).  The prefill and decode steps are
``models.transformer.prefill`` / ``decode_step`` themselves; the dry-run
bundles lower XLA programs and have no counterpart here."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf
from repro_torch.train.optimizer import AdamWConfig, adamw_update


def param_grads(loss, params: dict, cfg: ArchConfig) -> dict:
    """{name: d loss / d param}: zeros for a parameter of
    ``transformer.unreached_params(cfg)`` that the loss does not reach
    (an audio encoder's token embedding), as ``jax.grad`` gives; any
    other parameter the loss does not reach raises ValueError."""
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    stray = ({n for n, g in zip(params, grads) if g is None}
             - tf.unreached_params(cfg))
    if stray:
        raise ValueError(f"the loss of {cfg.name} does not reach "
                         f"{sorted(stray)}")
    return {n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(params.items(), grads)}


def make_train_fn(cfg: ArchConfig, hp: AdamWConfig = AdamWConfig()):
    """``train_step(model, params, opt_state, batch) -> metrics``: the loss
    and its gradient with respect to ``params`` (the model's ``{name:
    Parameter}``), then AdamW in place.  With ``cfg.microbatches`` > 1
    the microbatches' gradients accumulate in float32."""

    def grads_of(model, params, b):
        loss, metrics = tf.loss_fn(model, b, cfg)
        return loss, metrics, param_grads(loss, params, cfg)

    def train_step(model, params, opt_state, batch):
        k = cfg.microbatches
        B = next(iter(batch.values())).shape[0]
        if B % k != 0:                 # smoke/tiny batches: no accumulation
            k = 1
        if k == 1:
            loss, metrics, grads = grads_of(model, params, batch)
        else:
            gsum = {n: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for n, p in params.items()}
            lsum, msum = 0.0, {}
            for i in range(k):
                mb = {n: a.reshape((k, a.shape[0] // k) + a.shape[1:])[i]
                      for n, a in batch.items()}
                loss, metrics, grads = grads_of(model, params, mb)
                for n, g in grads.items():
                    gsum[n] += g.float()
                lsum = lsum + loss.detach()
                msum = {n: msum.get(n, 0.0) + m.detach()
                        for n, m in metrics.items()}
            grads = {n: g / k for n, g in gsum.items()}
            loss = lsum / k
            metrics = {n: m / k for n, m in msum.items()}
        _, _, gnorm = adamw_update(params, grads, opt_state, hp)
        return {**{n: m.detach() for n, m in metrics.items()},
                "loss": loss.detach(), "grad_norm": gnorm}

    return train_step
