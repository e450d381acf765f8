"""STAR-DP: the paper's asymmetric-replication protocol applied to
training (the port of ``repro/train/star_dp.py``).

* **epoch group commit**: training proceeds in commit epochs of K steps;
  the fence at each boundary snapshots (params, opt state, step) as the
  last *committed* state, and a failure reverts to it (the paper's
  two-version revert, §4.5.2, at trainer granularity).  The snapshot owns
  its memory: the trainer updates its tensors in place.
* **version-tagged replication (Thomas write rule)**: ``merge_replicas``
  applies incoming tensors iff their TID (the global step) is newer.
* **hybrid replication** (§5): dense tensors replicate by value; sparse
  updates (MoE expert deltas, embedding rows) as operations ``(indices,
  delta)``.  ``replication_bytes`` counts both.

State trees are dicts of tensors keyed by the model's parameter names
(``layers.3.moe.w_up``); the JAX package's trees stack layers on a leading
L axis (``layers/moe/w_up``).  ``replication_bytes`` counts what the JAX
package counts on its stacked tree, so for a layer tensor a "row" is a
layer (see there).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.convert import jax_key


def tree_map(fn, tree):
    """``fn`` over the tensors of nested dicts (other leaves too)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# epoch commit / revert
# ---------------------------------------------------------------------------
@dataclass
class CommitState:
    epoch: int
    step: int
    params: dict
    opt_state: dict


class EpochCommitLog:
    """In-memory committed snapshot + fence bookkeeping."""

    def __init__(self, steps_per_epoch: int = 8):
        self.steps_per_epoch = steps_per_epoch
        self.committed: CommitState | None = None
        self.fences = 0

    def maybe_fence(self, step: int, params, opt_state) -> bool:
        if step % self.steps_per_epoch != 0:
            return False
        epoch = step // self.steps_per_epoch
        # the fence: the snapshot becomes the commit point.  Copied, so the
        # step's in-place updates cannot reach the committed epoch (at
        # scale the second of the two record versions, §4.5.2)
        clone = lambda t: t.detach().clone()
        self.committed = CommitState(epoch, step, tree_map(clone, params),
                                     tree_map(clone, opt_state))
        self.fences += 1
        return True

    def revert(self) -> CommitState:
        if self.committed is None:
            raise RuntimeError("no committed epoch to revert to")
        return self.committed


# ---------------------------------------------------------------------------
# Thomas-rule replica merge
# ---------------------------------------------------------------------------
def merge_replicas(dst_params, dst_tid: int, src_params, src_tid: int):
    """Apply src iff strictly newer (per-replica TID = global step)."""
    if src_tid <= dst_tid:
        return dst_params, dst_tid
    return src_params, src_tid


def merge_tensor_groups(dst: dict, src: dict):
    """Group-granular merge: {name: (tensor, tid)}; the newest tid wins per
    group, whatever the order or duplication of messages (Thomas rule)."""
    out = dict(dst)
    for name, (tensor, tid) in src.items():
        if name not in out or tid > out[name][1]:
            out[name] = (tensor, tid)
    return out


# ---------------------------------------------------------------------------
# hybrid replication streams
# ---------------------------------------------------------------------------
def dense_value_stream(params) -> int:
    """Bytes to replicate the full dense state (value replication)."""
    return int(sum(p.numel() * p.element_size() for p in tree_leaves(params)))


def sparse_operation_stream(param, row_indices, delta_rows):
    """Operation replication for a row-sparse update: ship (indices, delta)
    and replay on the replica.  Returns (apply_fn, bytes)."""
    nbytes = int(row_indices.numel() * 4
                 + delta_rows.numel() * delta_rows.element_size())

    def apply_fn(replica_param):
        return replica_param.index_add(0, row_indices.long(),
                                       delta_rows.to(replica_param.dtype))

    return apply_fn, nbytes


def sparse_rows_touched(grads_row_norms, threshold: float = 0.0):
    """Rows with non-zero gradient: the 'single-partition transactions' of
    training, embedding rows and experts touched only by local data."""
    return torch.nonzero(grads_row_norms > threshold)[:, 0]


@dataclass
class ReplicationStats:
    value_bytes: int = 0
    op_bytes: int = 0

    @property
    def savings(self) -> float:
        return self.value_bytes / max(self.op_bytes, 1)


def replication_bytes(params: dict, grads: dict,
                      sparse_paths=("embed", "moe")) -> ReplicationStats:
    """Hybrid accounting: a sparse-path tensor ships (touched rows, delta);
    a dense one its full value.  Counted as the JAX package counts its
    stacked tree, on purpose: a leaf whose "/"-joined name contains a
    sparse path and has >= 2 axes ships the rows of its leading axis that
    have a non-zero gradient, each with a 4-byte index.  For ``embed``
    that is a vocabulary row; for the per-layer ``layers.<i>.moe.*``
    tensors, stacked there on a leading L axis, it is a whole LAYER (all
    of its experts), not an expert.  ``lm_head`` matches no sparse path."""
    stats = ReplicationStats()
    groups: dict = {}            # JAX leaf -> [(layer or None, name)]
    for name in params:
        key, i = jax_key(name)
        groups.setdefault(key, []).append((i, name))
    for key, members in groups.items():
        ps = [params[n] for _, n in members]
        gs = [grads[n] for _, n in members]
        stacked = members[0][0] is not None
        ndim = ps[0].dim() + stacked
        nbytes = sum(p.numel() * p.element_size() for p in ps)
        if any(s in key for s in sparse_paths) and ndim >= 2:
            if stacked:      # a row is a layer
                touched = sum(bool((g != 0).any()) for g in gs)
                row_bytes = ps[0].numel() * ps[0].element_size()
            else:
                g = gs[0]
                touched = int((g.reshape(g.shape[0], -1) != 0).any(1).sum())
                row_bytes = ps[0][0].numel() * ps[0].element_size()
            stats.op_bytes += touched * (row_bytes + 4)
            stats.value_bytes += nbytes
        else:
            stats.op_bytes += nbytes
            stats.value_bytes += nbytes
    return stats
