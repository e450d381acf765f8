"""Host training loop: STAR-DP epoch commits, fault recovery (the port of
``repro/train/trainer.py``).

* streams deterministic synthetic batches (``data.pipeline``);
* fences every ``steps_per_epoch`` steps: an in-memory commit and, with a
  ``checkpoint_dir``, a disk checkpoint (``train.checkpoint``);
* ``inject_failure()`` reverts to the last committed epoch: the live
  parameters and optimizer state are overwritten with the commit's copy;
* straggler watch: steps slower than ``straggler_factor`` x the running
  median are counted.

Every block and frontend trains, the SSD scan's (``mamba2``, ``hymba``)
through its backward kernel, MLA's attention through the flash backward
at head dims (96, 64).

On a mesh (``launch.mesh.Mesh`` over a process group's ranks) a rank
stores its shard of every parameter by ``sharding.param_specs`` and of
the optimizer state by ``sharding.opt_specs`` (ZeRO-1 over ``data``, the
single-master dense update), and keeps the gathered parameters in its
model for the step (``launch.steps``: the rank's batch shard, MoE layers
expert-parallel, gradients averaged over the batch axes, the owned state
updated, the masters gathered again).  GSPMD's tensor-parallel split of
the dense layers is not reproduced: what each rank stores is, and the
function computed is the same.  ``reshard`` gathers everything to the
host and places it on another mesh between epochs (the committed epoch
too, so a revert keeps its meaning); the disk checkpoint holds the whole
state, written by rank 0.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import make_batch
from repro_torch.device import resolve_device
from repro_torch.launch import sharding as shd
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
    which must be present), on ``mesh`` (None: one device; module
    docstring)."""

    def __init__(self, cfg: ArchConfig, tcfg: TrainerConfig, device=None,
                 mesh=None):
        self.device = resolve_device(device)
        self.cfg, self.tcfg = cfg, tcfg
        self.model = tf.LM(cfg, seed=0, device=self.device)
        self.model.requires_grad_(True)
        self.params = dict(self.model.named_parameters())
        self.mesh = None
        self.pshard = None
        self.opt_state = init_opt_state(self.params)
        self._place(mesh, self.params, self.opt_state)
        self.step = 0
        self.commit_log = EpochCommitLog(tcfg.steps_per_epoch)
        self.commit_log.maybe_fence(0, *self._stored())
        self.straggler_events = 0
        self._times: list[float] = []
        self.metrics_history: list[dict] = []

    # -- placement on the mesh ------------------------------------------
    @property
    def sharded(self) -> bool:
        return self.mesh is not None and self.mesh.distributed

    def _place(self, mesh, params: dict, opt_state: dict):
        """Place whole ``params`` and ``opt_state`` (any device) on
        ``mesh``: the model's parameters whole, the stored shards by the
        specs; build the step for it.  On one device the optimizer state
        is the live one, or copied into it in place."""
        live = None if self.sharded else self.opt_state
        self.mesh = mesh
        with torch.no_grad():
            for k, t in params.items():
                if t is not self.params[k]:
                    self.params[k].copy_(t)
        if self.sharded:
            self.pspecs = shd.param_specs(self.cfg, self.params, mesh)
            self.ospecs = shd.opt_specs(self.cfg, opt_state, self.pspecs,
                                        mesh)
        else:
            self.pspecs = self.ospecs = None
        if self.sharded:
            self.pshard, self.opt_state = self._stored_form(self.params,
                                                            opt_state)
        elif live is None:
            self.pshard = None
            self.opt_state = self._stored_form({}, opt_state)[1]
        elif opt_state is not live:
            with torch.no_grad():
                for s in ("master", "m", "v"):
                    for k, t in opt_state[s].items():
                        live[s][k].copy_(t)
            live["step"] = opt_state["step"].to(self.device, torch.int32,
                                                copy=True)
        self._step_fn = make_train_fn(self.cfg, self.tcfg.hp, mesh,
                                      self.ospecs)

    def _stored_form(self, params: dict, opt_state: dict):
        """Copies of whole ``params`` and ``opt_state`` as this rank stores
        them on the trainer's mesh (its shards; whole on one device)."""
        dev = self.device
        if self.sharded:
            cut = lambda t, sp: shd.place(t.detach().to(dev), sp, self.mesh)
            p = {k: cut(t, self.pspecs[k]) for k, t in params.items()}
            o = {s: {k: cut(t, self.ospecs[s][k])
                     for k, t in opt_state[s].items()}
                 for s in ("master", "m", "v")}
        else:
            p = {k: t.detach().to(dev, copy=True) for k, t in params.items()}
            o = {s: {k: t.to(dev, copy=True) for k, t in opt_state[s].items()}
                 for s in ("master", "m", "v")}
        o["step"] = opt_state["step"].to(dev, torch.int32, copy=True)
        return p, o

    def _stored(self):
        """(params, opt_state) as this rank stores them: its shards on a
        mesh, the live tensors on one device."""
        return (self.pshard if self.sharded else self.params), self.opt_state

    def _whole(self, params: dict, opt_state: dict):
        """Stored state (shards on a mesh) -> whole tensors."""
        if not self.sharded:
            return params, opt_state
        m = self.mesh
        p = {k: shd.gather(t, self.pspecs[k], m) for k, t in params.items()}
        o = {s: {k: shd.gather(t, self.ospecs[s][k], m)
                 for k, t in opt_state[s].items()}
             for s in ("master", "m", "v")}
        o["step"] = opt_state["step"]
        return p, o

    def state(self):
        """(params, opt_state), whole, on the trainer's device."""
        return self._whole(*self._stored())

    def load_state(self, params: dict, opt_state: dict | None = None,
                   step: int = 0):
        """Start from another state (``convert.params_from_jax`` /
        ``opt_state_from_jax`` output, or another trainer's ``state()``):
        overwrite the live state and commit it as step ``step``'s epoch, in
        a new commit log, as a new trainer commits its initial state."""
        if opt_state is None:
            opt_state = self.state()[1]
        self._place(self.mesh, params, opt_state)
        self.step = step
        self.commit_log = EpochCommitLog(self.tcfg.steps_per_epoch)
        self.commit_log.maybe_fence(step, *self._stored())

    def _copy_in(self, params, opt_state):
        """Stored state (as :meth:`_stored` gives it) back into the live
        tensors."""
        with torch.no_grad():
            if self.sharded:
                for k, t in params.items():
                    self.pshard[k].copy_(t)
                    self.params[k].copy_(shd.gather(t, self.pspecs[k],
                                                    self.mesh))
            else:
                for k, t in params.items():
                    self.params[k].copy_(t)
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
            if self.sharded:
                with torch.no_grad():
                    for k, p in self.params.items():
                        self.pshard[k].copy_(p[shd.shard_slices(
                            tuple(p.shape), self.pspecs[k], self.mesh)])
            metrics = {k: float(v) for k, v in metrics.items()}   # syncs
            dt = time.perf_counter() - t0
            self.step += 1
            self._watch_stragglers(dt)
            self.metrics_history.append(metrics | {"step": self.step,
                                                   "step_s": dt})
            if self.commit_log.maybe_fence(self.step, *self._stored()):
                if self.tcfg.checkpoint_dir:
                    self._save_checkpoint()
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

    def _save_checkpoint(self):
        """The whole state to disk (rank 0 of a mesh writes it)."""
        params, opt = self.state()
        if not self.sharded or self.mesh.rank == 0:
            save_checkpoint(self.tcfg.checkpoint_dir, self.step, params, opt,
                            {"epoch": self.step // self.tcfg.steps_per_epoch})
        if self.sharded:
            import torch.distributed as dist
            dist.barrier()

    def restore_from_disk(self):
        params, opt = self.state()
        out = restore_checkpoint(self.tcfg.checkpoint_dir, params, opt)
        if out is None:
            return None
        meta = out[2]
        self._place(self.mesh, params, opt)
        self.step = meta["step"]
        self.commit_log.maybe_fence(self.step, *self._stored())
        return meta

    # ------------------------------------------------------------------
    # elasticity
    # ------------------------------------------------------------------
    def reshard(self, new_mesh):
        """Scale the cluster between epochs: gather the state (and the
        committed epoch) to the host, then place it on ``new_mesh``."""
        host = lambda t: t.detach().to("cpu", copy=True)
        params, opt = self.state()
        params = {k: host(t) for k, t in params.items()}
        opt = {s: ({k: host(t) for k, t in opt[s].items()}
                   if s != "step" else host(opt[s])) for s in opt}
        c = self.commit_log.committed
        if c is not None:
            cp, co = self._whole(c.params, c.opt_state)
            cp = {k: host(t) for k, t in cp.items()}
            co = {s: ({k: host(t) for k, t in co[s].items()}
                      if s != "step" else host(co[s])) for s in co}
        self._place(new_mesh, params, opt)
        if c is not None:
            # the committed epoch, stored as the new mesh stores state
            c.params, c.opt_state = self._stored_form(cp, co)

    def replication_report(self):
        """Hybrid replication accounting on the current gradient (the
        Fig. 15 analogue for STAR-DP)."""
        batch = make_batch(self.cfg, "train", self.tcfg.seq_len,
                           self.tcfg.batch, seed=123)
        batch = {k: v.to(self.device) for k, v in batch.items()}
        loss, _ = tf.loss_fn(self.model, batch, self.cfg, mesh=self.mesh)
        return replication_bytes(self.params, param_grads(loss, self.params,
                                                          self.cfg))
