"""Parity of the port's training path (``repro_torch.data``, ``train``,
``launch.steps``, ``launch.train``, ``models.transformer.loss_fn``) with the
JAX package's, on the SMOKE configs in float32 on the CPU (the port's
kernel wrappers run their plain versions here; the backward kernels are
held to them on the card by chip_smoke.py, phase 11).  Inputs are made
with numpy from a seed; the JAX parameters and optimizer state are carried
across by ``convert.params_from_jax`` and ``opt_state_from_jax``.

The JAX side of the trainer tests is the JAX package's training step
(``launch.steps.make_train_fn``), fences (``EpochCommitLog``) and
checkpoints, looped as ``repro.train.trainer.Trainer.run`` loops them, on
one device without a mesh (:class:`JaxTrainer`): where jax (0.9.0 here)
types the arrays that ``Trainer`` places on its mesh by their sharding,
its step raises ``ShardingTypeError`` on the vocab-sharded embedding
gather (``src/repro/models/transformer.py:157``, ROADMAP Queue 3), so
``Trainer`` itself is not a dependable oracle across jax versions.

Tolerances, each with its reason:
- data, checkpoints, the revert, the replication report, the Thomas
  merges: exact (integers, copies, files);
- ``cross_entropy``, ``chunked_ce``: 1e-5 (float32, sums in another
  order);
- ``adamw_update`` on equal gradients: within 1e-6 of each tensor's
  largest magnitude (the same float32 arithmetic in the same order, but
  XLA contracts a multiply and an add into one fused rounding);
- ``loss_fn`` and its gradients: loss 1e-5 relative, each gradient within
  1e-4 of its tensor's largest magnitude (attention, the MoE combine and
  the chunked CE sum in another order; XLA fuses and reorders products);
- K Trainer steps: losses and gradient norms 1e-4 relative; parameters
  within 2 x the sum of the steps' learning rates, because Adam's
  normalised step moves a coordinate by up to lr whatever its gradient's
  size, so a coordinate whose gradient is at the noise level can move
  either way on the two sides; and, leaf by leaf, 99.9 % of them within
  1e-5 (a wrong gradient moves most of its leaf by ~lr).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.data.pipeline import make_batch as jmake_batch
from repro.launch.steps import make_train_fn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.train import checkpoint as jckpt
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro.train.star_dp import EpochCommitLog as JEpochCommitLog
from repro.train.star_dp import replication_bytes as jreplication_bytes
from repro_torch.configs.base import get_arch
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.data.pipeline import make_batch, synthetic_stream
from repro_torch.launch.steps import param_grads
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.train import compression as tcomp
from repro_torch.train import optimizer as topt
from repro_torch.train.checkpoint import latest_checkpoint, save_checkpoint
from repro_torch.train.star_dp import (ReplicationStats, dense_value_stream,
                                       merge_replicas, merge_tensor_groups,
                                       sparse_operation_stream,
                                       sparse_rows_touched)
from repro_torch.train.trainer import Trainer, TrainerConfig

F32 = np.float32
MOE, DENSE = "granite-moe-1b-a400m", "granite-8b"
HYMBA, MAMBA2 = "hymba-1.5b", "mamba2-130m"
MLA, AUDIO, VISION = "minicpm3-4b", "hubert-xlarge", "internvl2-26b"


def _cfgs(name, **kw):
    """The same SMOKE config on both sides (float32 unless kw says)."""
    kw = {"dtype": "float32", **kw}
    j = dataclasses.replace(jget_arch(name, smoke=True), **kw)
    t = dataclasses.replace(get_arch(name, smoke=True), **kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _hp():
    return dict(lr=1e-3, warmup_steps=5)


class JaxTrainer:
    """``repro.train.trainer.Trainer``'s state, ``run`` and
    ``replication_report`` on one device: the JAX package's jitted
    ``make_train_fn`` step, ``make_batch`` seeds, ``EpochCommitLog``
    fences and ``save_checkpoint`` at each fence."""

    def __init__(self, cfg, seq_len, batch, steps_per_epoch, hp,
                 checkpoint_dir=None):
        self.cfg, self.seq_len, self.batch = cfg, seq_len, batch
        self.spe, self.dir = steps_per_epoch, checkpoint_dir
        self.params = jtf.init_params(cfg, jax.random.key(0))
        self.opt_state = jopt.init_opt_state(self.params)
        self.step = 0
        self.commit_log = JEpochCommitLog(steps_per_epoch)
        self.commit_log.maybe_fence(0, self.params, self.opt_state)
        self.metrics_history = []
        self._step_fn = jax.jit(make_train_fn(cfg, None, hp),
                                donate_argnums=(0, 1))

    def run(self, n_steps, seed=0):
        for _ in range(n_steps):
            batch = jmake_batch(self.cfg, "train", self.seq_len, self.batch,
                                seed=seed * 1_000_003 + self.step)
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch)
            self.step += 1
            self.metrics_history.append(
                {k: float(v) for k, v in metrics.items()} | {"step":
                                                            self.step})
            if (self.commit_log.maybe_fence(self.step, self.params,
                                            self.opt_state) and self.dir):
                jckpt.save_checkpoint(self.dir, self.step, self.params,
                                      self.opt_state,
                                      {"epoch": self.step // self.spe})

    def replication_report(self):
        batch = jmake_batch(self.cfg, "train", self.seq_len, self.batch,
                            seed=123)
        grads = jax.grad(lambda p: jtf.loss_fn(p, batch, self.cfg)[0])(
            self.params)
        return jreplication_bytes(self.params, grads)


def _pair(name, tmp=None, **kw):
    """A JAX trainer and a CPU port Trainer started from the JAX one's
    parameters and optimizer state."""
    jcfg, tcfg = _cfgs(name, **kw)
    tc = dict(seq_len=32, batch=2, steps_per_epoch=4, checkpoint_dir=tmp)
    jt = JaxTrainer(jcfg, **tc, hp=jopt.AdamWConfig(**_hp()))
    tt = Trainer(tcfg, TrainerConfig(**tc, hp=topt.AdamWConfig(**_hp())),
                 device="cpu")
    tt.load_state(params_from_jax(_np(jt.params), tcfg, device="cpu"),
                  opt_state_from_jax(_np(jt.opt_state), tcfg, device="cpu"))
    return jt, tt


def _flat_jax(tree, cfg):
    """A JAX parameter tree as the port's {name: numpy} (layers
    unstacked), through ``params_from_jax``."""
    return {k: v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
            for k, v in params_from_jax(_np(tree), cfg, device="cpu").items()}


def _params_close(tt, want, bound):
    """The port trainer's parameters against the JAX ones ({name: numpy}):
    every coordinate within ``bound`` (2 x the steps' learning rates) and,
    leaf by leaf, 99.9 % of them within 1e-5."""
    for k, t in tt.params.items():
        d = np.abs(t.detach().numpy() - want[k]).reshape(-1)
        assert d.max() <= bound, (k, d.max(), bound)
        assert np.quantile(d, 0.999) <= 1e-5, (k, np.quantile(d, 0.999))


def _state(tr):
    """A port trainer's parameters and optimizer state, copied."""
    return {"p": {k: v.detach().clone() for k, v in tr.params.items()},
            "o": {s: {k: v.clone() for k, v in tr.opt_state[s].items()}
                  for s in ("master", "m", "v")},
            "step": int(tr.opt_state["step"])}


def _state_equal(a, b):
    return (a["step"] == b["step"]
            and all(torch.equal(a["p"][k], b["p"][k]) for k in a["p"])
            and all(torch.equal(a["o"][s][k], b["o"][s][k])
                    for s in a["o"] for k in a["o"][s]))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_make_batch_bit_equal(kind):
    jcfg, tcfg = _cfgs(MOE)
    for seed in (0, 7, 1_000_003 * 2 + 5):
        j = jmake_batch(jcfg, kind, 48, 3, seed=seed)
        t = make_batch(tcfg, kind, 48, 3, seed=seed)
        assert set(j) == set(t)
        for k in j:
            assert t[k].dtype == torch.int32 and t[k].device.type == "cpu"
            assert np.array_equal(t[k].numpy(), np.asarray(j[k])), (kind, k)
    steps = list(synthetic_stream(tcfg, 16, 2, 3, seed=1))
    assert len(steps) == 3 and np.array_equal(
        steps[2]["tokens"].numpy(),
        np.asarray(jmake_batch(jcfg, "train", 16, 2, seed=100_003 + 2)[
            "tokens"]))


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------
def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 9, 50)).astype(F32) * 3
    labels = rng.integers(0, 50, (2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) > 0.3).astype(F32)
    for m in (None, mask):
        want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                     None if m is None else jnp.asarray(m))
        got = tlayers.cross_entropy(torch.tensor(logits), torch.tensor(labels),
                                    None if m is None else torch.tensor(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("S", [64, 512, 2048])
def test_chunked_ce_matches_jax(S):
    """S <= the 512-token chunk (one plain cross entropy), S = 512 and
    S = 4 chunks, each chunk recomputed in the backward; value and the
    gradient of the hidden state."""
    jcfg, tcfg = _cfgs(DENSE)
    jp = jtf.init_params(jcfg, jax.random.key(0))
    model = ttf.LM(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(_np(jp), tcfg, device="cpu"))
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(F32)
    labels = rng.integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    jv, jg = jax.value_and_grad(lambda x: jtf.chunked_ce(
        jp, x, jnp.asarray(labels), None, jcfg))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    tv = ttf.chunked_ce(model, xt, torch.tensor(labels), None, tcfg)
    (tg,) = torch.autograd.grad(tv, xt)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-5 * float(np.abs(jg).max()))


@pytest.mark.parametrize("name", [MOE, DENSE, "glm4-9b", HYMBA, MAMBA2,
                                  MLA, AUDIO, VISION])
def test_loss_fn_and_gradients_match_jax(name):
    """``loss_fn`` (embed, every block under remat, the final norm, the
    chunked CE; MoE's aux loss) and the gradient of every parameter,
    against ``jax.value_and_grad(tf.loss_fn)``, on 2 x 64 tokens: GLM-4's
    partial RoPE, the SSD scan's gradient (the port's ``ssd`` Function
    over its plain version here; the JAX model differentiates its chunked
    algorithm) in the Hymba and Mamba-2 blocks, MLA's expanded form, the
    audio frontend (HuBERT's token embedding gets a zero gradient, as
    under ``jax.grad``) and the vision frontend (8 patches before 56
    tokens, the loss on the tokens alone)."""
    jcfg, tcfg = _cfgs(name)
    jp = jtf.init_params(jcfg, jax.random.key(0))
    batch = jmake_batch(jcfg, "train", 64, 2, seed=3)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_fn(p, batch, jcfg), has_aux=True))(jp)
    model = ttf.LM(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(_np(jp), tcfg, device="cpu"))
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    tl, tm = ttf.loss_fn(model, make_batch(tcfg, "train", 64, 2, seed=3),
                         tcfg)
    grads = param_grads(tl, params, tcfg)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   rtol=1e-5, atol=1e-7)
    want = _flat_jax(jg, tcfg)
    assert set(want) == set(grads)
    for k, g in grads.items():
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(g.numpy(), want[k], rtol=0,
                                   atol=1e-4 * scale + 1e-12, err_msg=k)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------
def test_adamw_update_matches_jax():
    """Three steps on the same gradients (the first clipped: the global
    norm is above grad_clip), warmup still on."""
    jcfg, tcfg = _cfgs(DENSE)
    jp = jtf.init_params(jcfg, jax.random.key(0))
    jo = jopt.init_opt_state(jp)
    tp = params_from_jax(_np(jp), tcfg, device="cpu")
    to = topt.init_opt_state(tp)
    hp = dict(lr=1e-2, warmup_steps=4, grad_clip=1.0)
    rng = np.random.default_rng(0)
    for step in range(3):
        g = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape)
                                               .astype(F32) * 0.1), jp)
        jp, jo, jn = jopt.adamw_update(jp, g, jo, jopt.AdamWConfig(**hp))
        tg = params_from_jax(_np(g), tcfg, device="cpu")
        tp, to, tn = topt.adamw_update(tp, tg, to, topt.AdamWConfig(**hp))
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        assert int(to["step"]) == int(jo["step"]) == step + 1
    want = {"params": _flat_jax(jp, tcfg),
            **{s: _flat_jax(jo[s], tcfg) for s in ("master", "m", "v")}}
    for s, got in (("params", tp), *((s, to[s]) for s in ("master", "m",
                                                          "v"))):
        for k, t in got.items():
            w = want[s][k]
            np.testing.assert_allclose(t.numpy(), w, rtol=0,
                                       atol=1e-6 * float(np.abs(w).max()),
                                       err_msg=f"{s} {k}")


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", [MOE, DENSE, HYMBA, MAMBA2, AUDIO, MLA])
def test_trainer_steps_match_jax(name):
    K = 4
    jt, tt = _pair(name)
    jt.run(K)
    tt.run(K)
    for jm, tm in zip(jt.metrics_history, tt.metrics_history):
        assert jm["step"] == tm["step"]
        for k in ("loss", "ce", "aux", "grad_norm"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-7,
                                       err_msg=k)
    lr = _hp()["lr"]
    bound = 2 * sum(lr * min(1.0, (t + 1) / _hp()["warmup_steps"])
                    for t in range(K))
    _params_close(tt, _flat_jax(jt.params, tt.cfg), bound)
    assert int(tt.opt_state["step"]) == K and tt.commit_log.fences == 2


def test_microbatch_accumulation_matches_jax():
    """``cfg.microbatches`` = 2: the two microbatches' gradients accumulate
    in float32 and their mean drives one AdamW step, as the JAX package's
    ``lax.scan`` does; one step on 4 x 32 tokens of Granite-MoE SMOKE."""
    jcfg, tcfg = _cfgs(MOE, microbatches=2)
    hp = _hp()
    jt = JaxTrainer(jcfg, 32, 4, 4, jopt.AdamWConfig(**hp))
    tt = Trainer(tcfg, TrainerConfig(seq_len=32, batch=4, steps_per_epoch=4,
                                     hp=topt.AdamWConfig(**hp)),
                 device="cpu")
    tt.load_state(params_from_jax(_np(jt.params), tcfg, device="cpu"),
                  opt_state_from_jax(_np(jt.opt_state), tcfg, device="cpu"))
    jt.run(1)
    tt.run(1)
    for k in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(tt.metrics_history[0][k],
                                   jt.metrics_history[0][k], rtol=1e-4,
                                   err_msg=k)
    _params_close(tt, _flat_jax(jt.params, tcfg),
                  2 * hp["lr"] / hp["warmup_steps"])


def test_revert_and_disk_resume_are_bit_equal(tmp_path):
    jcfg, tcfg = _cfgs(MOE)
    tr = Trainer(tcfg, TrainerConfig(seq_len=32, batch=2, steps_per_epoch=4,
                                     checkpoint_dir=str(tmp_path),
                                     hp=topt.AdamWConfig(**_hp())),
                 device="cpu")
    tr.run(4)                                  # fence + checkpoint at 4
    at_fence = _state(tr)
    assert tr.commit_log.committed.step == 4
    tr.run(2)                                  # uncommitted
    assert not _state_equal(_state(tr), at_fence)
    assert tr.inject_failure() == 4 and tr.step == 4
    assert _state_equal(_state(tr), at_fence)
    tr.run(2)                                  # replay
    assert tr.step == 6
    assert tr.inject_failure() == 4            # the commit kept its copy
    assert _state_equal(_state(tr), at_fence)
    tr.run(3)
    meta = tr.restore_from_disk()
    assert meta == {"step": 4, "epoch": 1} and tr.step == 4
    assert _state_equal(_state(tr), at_fence)
    assert latest_checkpoint(tmp_path).name == "step_0000000004"


def test_checkpoints_cross_between_the_two_trainers(tmp_path):
    """A directory the JAX trainer wrote (bf16 parameters stored as
    float32, layers stacked) restores into the port bit for bit, and one
    the port wrote restores into the JAX package's ``restore_checkpoint``.
    """
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jt, _ = _pair(MOE, str(jdir), dtype="bfloat16")
    jt.run(4)
    _, tcfg = _cfgs(MOE, dtype="bfloat16")
    tr = Trainer(tcfg, TrainerConfig(seq_len=32, batch=2, steps_per_epoch=4,
                                     checkpoint_dir=str(jdir)), device="cpu")
    meta = tr.restore_from_disk()
    assert meta["step"] == 4 and tr.step == 4
    want = params_from_jax(_np(jt.params), tcfg, device="cpu")
    for k, t in tr.params.items():
        assert t.dtype == want[k].dtype and torch.equal(t.detach(), want[k])
    assert tr.params["embed"].dtype == torch.bfloat16
    wo = opt_state_from_jax(_np(jt.opt_state), tcfg, device="cpu")
    for s in ("master", "m", "v"):
        for k, t in tr.opt_state[s].items():
            assert torch.equal(t, wo[s][k]), (s, k)
    assert int(tr.opt_state["step"]) == 4
    save_checkpoint(tdir, 4, tr.params, tr.opt_state, {"epoch": 1})
    back = jckpt.restore_checkpoint(tdir, jt.params, jt.opt_state)
    assert back[2] == {"step": 4, "epoch": 1}
    for a, b in zip(jax.tree.leaves((jt.params, jt.opt_state)),
                    jax.tree.leaves(back[:2])):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a),
                                                     np.asarray(b))


def test_replication_report_counts_what_jax_counts():
    """The hybrid-replication bytes on Granite-MoE SMOKE equal the JAX
    report exactly.  The JAX package stacks layers on a leading axis, so
    for ``layers/moe/*`` a "row" is a layer: every layer's experts ship
    as one row (the port reproduces this on purpose, ROADMAP Queue 3)."""
    jt, tt = _pair(MOE, dtype="bfloat16")
    js, ts = jt.replication_report(), tt.replication_report()
    assert isinstance(ts, ReplicationStats)
    assert (ts.value_bytes, ts.op_bytes) == (js.value_bytes, js.op_bytes)
    cfg = tt.cfg
    batch = make_batch(cfg, "train", 32, 2, seed=123)
    rows = len(np.unique(batch["tokens"].numpy()))
    p = tt.params
    moe = [k for k in p if k.startswith("layers.0.moe.")]
    dense = [k for k in p if ".moe." not in k and k != "embed"]
    want = (sum(cfg.n_layers * (p[k].numel() * p[k].element_size() + 4)
                for k in moe)                            # a layer a row
            + rows * (cfg.d_model * 2 + 4)               # embed rows
            + sum(p[k].numel() * p[k].element_size() for k in dense))
    assert ts.op_bytes == want
    assert ts.value_bytes == dense_value_stream(p)


def test_merge_replicas_thomas_rule():
    p_old, p_new = {"w": torch.zeros(2)}, {"w": torch.ones(2)}
    merged, tid = merge_replicas(p_old, 5, p_new, 7)
    assert tid == 7 and merged is p_new
    merged, tid = merge_replicas(p_new, 7, p_old, 5)   # stale ignored
    assert tid == 7 and merged is p_new


def test_merge_tensor_groups_out_of_order():
    a = {"embed": ("v1", 3)}
    b = {"embed": ("v2", 5), "mlp": ("m1", 2)}
    m1 = merge_tensor_groups(a, b)
    m2 = merge_tensor_groups(b, a)                     # reversed arrival
    assert m1 == m2 == {"embed": ("v2", 5), "mlp": ("m1", 2)}


def test_sparse_operation_stream_replays_the_rows():
    param = torch.zeros(6, 3)
    idx = sparse_rows_touched(torch.tensor([0.0, 2.0, 0.0, 1.0, 0.0, 0.0]))
    assert idx.tolist() == [1, 3]
    delta = torch.ones(2, 3)
    apply_fn, nbytes = sparse_operation_stream(param, idx, delta)
    assert nbytes == 2 * 4 + 6 * 4
    out = apply_fn(param)
    assert out[1].tolist() == out[3].tolist() == [1.0] * 3
    assert float(out.sum()) == 6.0 and float(param.sum()) == 0.0


# ---------------------------------------------------------------------------
# gradient compression (tests/test_compression_invariants.py's cases)
# ---------------------------------------------------------------------------
def test_topk_roundtrip_exact_on_sparse():
    g = torch.zeros(1000)
    g[torch.tensor([3, 500, 999])] = torch.tensor([5.0, -2.0, 1.0])
    idx, vals, shape = tcomp.topk_encode(g, frac=0.003)
    assert torch.equal(tcomp.topk_decode(idx, vals, shape, torch.float32), g)


def test_codecs_match_jax():
    g = np.random.default_rng(0).standard_normal(4096).astype(F32)
    ji, jv, _ = jcomp.topk_encode(jnp.asarray(g), 0.01)
    ti, tv, _ = tcomp.topk_encode(torch.tensor(g), 0.01)
    assert np.array_equal(np.sort(ti.numpy()), np.sort(np.asarray(ji)))
    assert ti.dtype == torch.int32
    jq, js = jcomp.int8_encode(jnp.asarray(g))
    tq, ts = tcomp.int8_encode(torch.tensor(g))
    assert float(ts) == float(js) and np.array_equal(tq.numpy(),
                                                     np.asarray(jq))
    out = tcomp.int8_decode(tq, ts, torch.float32)
    assert float((out - torch.tensor(g)).abs().max()) <= float(ts) * 0.5 + 1e-6


def test_error_feedback_converges():
    """The sum of the compressed messages approaches the sum of the true
    gradients: error feedback ships the residual eventually."""
    g = torch.tensor(np.random.default_rng(1).standard_normal(256)
                     .astype(F32))
    comp = tcomp.CompressedAllReduce("topk", frac=0.05)
    true_sum, sent_sum = torch.zeros(256), torch.zeros(256)
    for _ in range(120):
        true_sum += g
        sent_sum += comp({"w": g})["w"]
    rel = float((sent_sum - true_sum).norm() / true_sum.norm())
    assert rel < 0.2, rel
    lag = float((sent_sum - true_sum).norm() / g.norm())
    assert lag < 1.5 / comp.frac, lag
    assert comp.stats.ratio > 5.0          # ~20x fewer bytes at frac = 5 %
    assert tcomp.CompressedAllReduce("none")({"w": g})["w"] is g
    with pytest.raises(ValueError):
        tcomp.CompressedAllReduce("fp4")


def test_train_step_with_int8_compression_trains():
    """bf16 Granite-MoE SMOKE: six steps of loss, int8-compressed
    gradients and AdamW; the loss falls, and bf16 gradients ship at 2x
    fewer bytes."""
    _, cfg = _cfgs(MOE, dtype="bfloat16")
    model = ttf.LM(cfg, device="cpu")
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    opt = topt.init_opt_state(params)
    comp = tcomp.CompressedAllReduce("int8")
    losses = []
    for step in range(6):
        batch = make_batch(cfg, "train", 64, 4, seed=step)
        loss, _ = ttf.loss_fn(model, batch, cfg)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        topt.adamw_update(params, comp(grads), opt,
                          topt.AdamWConfig(lr=1e-3, warmup_steps=2))
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert comp.stats.ratio > 1.9


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def test_entry_points_default_to_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from repro_torch.launch import train
    _, cfg = _cfgs(MOE)
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(cfg, TrainerConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--arch", MOE, "--smoke"])
    tr = train.main(["--arch", MOE, "--smoke", "--device", "cpu", "--steps",
                     "3", "--steps-per-epoch", "2", "--seq", "16",
                     "--batch", "2"])
    assert tr.step == 3 and tr.device.type == "cpu"
    assert "done on cpu: 3 steps, 2 epoch fences" in capsys.readouterr().out


def test_train_entry_point_trains_hymba(capsys):
    """``python -m repro_torch.launch.train --arch hymba-1.5b --smoke
    --device cpu``: the Hymba block (attention and the SSD scan) trains
    through the entry point, and its loss falls."""
    from repro_torch.launch import train
    tr = train.main(["--arch", HYMBA, "--smoke", "--device", "cpu",
                     "--steps", "6", "--steps-per-epoch", "3", "--seq",
                     "32", "--batch", "2"])
    losses = [m["loss"] for m in tr.metrics_history]
    assert tr.step == 6 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert "done on cpu: 6 steps, 3 epoch fences" in capsys.readouterr().out


def test_untrainable_configs_raise():
    """Every config trains now: MiniCPM3's MLA, HuBERT's audio frames and
    InternVL2's patches each take two finite steps through ``Trainer``.
    ``reshard`` to a 1 x 1 mesh keeps every tensor of the state and of the
    committed epoch bit-equal (several ranks: tests/test_torch_dist_lm.py).
    A config name that does not exist is refused by name."""
    from repro_torch.launch.mesh import make_host_mesh
    for name in (MLA, AUDIO, VISION):
        _, cfg = _cfgs(name)
        tr = Trainer(cfg, TrainerConfig(seq_len=16, batch=2), device="cpu")
        tr.run(2)
        assert tr.step == 2 and all(np.isfinite(m["loss"])
                                    for m in tr.metrics_history)
    before = _state_leaves(tr)
    committed = [t.clone() for t in _tree_leaves(
        {"p": tr.commit_log.committed.params,
         "o": tr.commit_log.committed.opt_state})]
    tr.reshard(make_host_mesh(1, 1))
    after = _state_leaves(tr)
    assert len(before) == len(after) and all(
        a.dtype == b.dtype and torch.equal(a, b)
        for a, b in zip(before, after))
    assert all(torch.equal(a, b) for a, b in zip(committed, _tree_leaves(
        {"p": tr.commit_log.committed.params,
         "o": tr.commit_log.committed.opt_state})))
    with pytest.raises(ValueError, match="no-such-arch"):
        get_arch("no-such-arch")


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    return [tree]


def _state_leaves(tr):
    return [t.detach().clone() for t in _tree_leaves(
        {"p": tr.params, "o": tr.opt_state})]


@pytest.mark.parametrize("name", [AUDIO, DENSE])
def test_param_grads_refuses_an_unreached_parameter(name):
    """``param_grads`` gives zeros only to what ``unreached_params`` names
    (HuBERT's token embedding, which ``loss_fn`` never reads); a parameter
    the loss does not reach outside that set raises ValueError naming it."""
    _, cfg = _cfgs(name)
    model = ttf.LM(cfg, device="cpu")
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    loss, _ = ttf.loss_fn(model, make_batch(cfg, "train", 16, 2, seed=1),
                          cfg)
    grads = param_grads(loss, params, cfg)
    assert set(grads) == set(params)
    for k in ttf.unreached_params(cfg):
        assert not grads[k].any()                          # exact: zeros
    stray = torch.zeros(3, requires_grad=True)
    loss, _ = ttf.loss_fn(model, make_batch(cfg, "train", 16, 2, seed=1),
                          cfg)
    with pytest.raises(ValueError, match="stray"):
        param_grads(loss, {**params, "stray": stray}, cfg)
