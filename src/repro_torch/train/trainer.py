"""Host training loop: STAR-DP epoch commits, fault recovery (the port of
``repro/train/trainer.py``).

* streams deterministic synthetic batches (``data.pipeline``);
* fences every ``steps_per_epoch`` steps: an in-memory commit and, with a
  ``checkpoint_dir``, a disk checkpoint (``train.checkpoint``);
* ``inject_failure()`` reverts to the last committed epoch: the live
  parameters and optimizer state are overwritten with the commit's copy;
* straggler watch: steps slower than ``straggler_factor`` x the running
  median are counted.

One device, no mesh: elastic ``reshard`` and expert parallelism wait for
the ``torch.distributed`` slice (ROADMAP Queue 1, item 7e).  Every block
and frontend trains, the SSD scan's (``mamba2``, ``hymba``) through its
backward kernel, MLA's attention through the flash backward at head dims
(96, 64).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import make_batch
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_fn, param_grads
from repro_torch.models import transformer as tf
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.star_dp import EpochCommitLog, replication_bytes


@dataclass
class TrainerConfig:
    seq_len: int = 128
    batch: int = 8
    steps_per_epoch: int = 8
    checkpoint_dir: str | None = None
    straggler_factor: float = 3.0
    hp: AdamWConfig = field(default_factory=AdamWConfig)


class Trainer:
    """Trains ``cfg``'s model (random weights from seed 0, as the JAX
    trainer draws its own from key 0) on ``device`` (``None`` means cuda,
    which must be present)."""

    def __init__(self, cfg: ArchConfig, tcfg: TrainerConfig, device=None):
        self.device = resolve_device(device)
        self.cfg, self.tcfg = cfg, tcfg
        self.model = tf.LM(cfg, seed=0, device=self.device)
        self.model.requires_grad_(True)
        self.params = dict(self.model.named_parameters())
        self.opt_state = init_opt_state(self.params)
        self.step = 0
        self.commit_log = EpochCommitLog(tcfg.steps_per_epoch)
        self.commit_log.maybe_fence(0, self.params, self.opt_state)
        self.straggler_events = 0
        self._times: list[float] = []
        self.metrics_history: list[dict] = []
        self._step_fn = make_train_fn(cfg, tcfg.hp)

    def load_state(self, params: dict, opt_state: dict | None = None,
                   step: int = 0):
        """Start from another state (``convert.params_from_jax`` /
        ``opt_state_from_jax`` output, or another trainer's): overwrite the
        live state and commit it as step ``step``'s epoch, in a new commit
        log, as a new trainer commits its initial state."""
        self._copy_in(params, opt_state)
        self.step = step
        self.commit_log = EpochCommitLog(self.tcfg.steps_per_epoch)
        self.commit_log.maybe_fence(step, self.params, self.opt_state)

    def _copy_in(self, params, opt_state):
        with torch.no_grad():
            for k, t in params.items():
                self.params[k].copy_(t)
            if opt_state is not None:
                for s in ("master", "m", "v"):
                    for k, t in opt_state[s].items():
                        self.opt_state[s][k].copy_(t)
                self.opt_state["step"] = opt_state["step"].to(
                    self.device, torch.int32, copy=True)

    # ------------------------------------------------------------------
    def run(self, n_steps: int, seed: int = 0):
        for _ in range(n_steps):
            batch = make_batch(self.cfg, "train", self.tcfg.seq_len,
                               self.tcfg.batch,
                               seed=seed * 1_000_003 + self.step)
            batch = {k: v.to(self.device) for k, v in batch.items()}
            t0 = time.perf_counter()
            metrics = self._step_fn(self.model, self.params, self.opt_state,
                                    batch)
            metrics = {k: float(v) for k, v in metrics.items()}   # syncs
            dt = time.perf_counter() - t0
            self.step += 1
            self._watch_stragglers(dt)
            self.metrics_history.append(metrics | {"step": self.step,
                                                   "step_s": dt})
            if self.commit_log.maybe_fence(self.step, self.params,
                                           self.opt_state):
                if self.tcfg.checkpoint_dir:
                    save_checkpoint(
                        self.tcfg.checkpoint_dir, self.step, self.params,
                        self.opt_state,
                        {"epoch": self.step // self.tcfg.steps_per_epoch})
        return self.metrics_history[-1]

    def _watch_stragglers(self, dt: float):
        self._times.append(dt)
        if len(self._times) >= 5:
            med = float(np.median(self._times[-20:]))
            if dt > self.tcfg.straggler_factor * med:
                self.straggler_events += 1

    # ------------------------------------------------------------------
    # fault tolerance
    # ------------------------------------------------------------------
    def inject_failure(self):
        """Node failure mid-epoch: uncommitted steps are lost; revert to
        the last committed epoch (STAR §4.5: epoch group commit + revert).
        The commit keeps its own copy, so it can be reverted to again."""
        c = self.commit_log.revert()
        self._copy_in(c.params, c.opt_state)
        self.step = c.step
        return c.step

    def restore_from_disk(self):
        out = restore_checkpoint(self.tcfg.checkpoint_dir, self.params,
                                 self.opt_state)
        if out is None:
            return None
        meta = out[2]
        self.step = meta["step"]
        self.commit_log.maybe_fence(self.step, self.params, self.opt_state)
        return meta

    # ------------------------------------------------------------------
    # elasticity
    # ------------------------------------------------------------------
    def reshard(self, new_mesh):
        raise NotImplementedError(
            "reshard needs a mesh of several cards: it waits for the "
            "torch.distributed slice (ROADMAP Queue 1, item 7e)")

    def replication_report(self):
        """Hybrid replication accounting on the current gradient (the
        Fig. 15 analogue for STAR-DP)."""
        batch = make_batch(self.cfg, "train", self.tcfg.seq_len,
                           self.tcfg.batch, seed=123)
        batch = {k: v.to(self.device) for k, v in batch.items()}
        loss, _ = tf.loss_fn(self.model, batch, self.cfg)
        return replication_bytes(self.params, param_grads(loss, self.params,
                                                          self.cfg))
