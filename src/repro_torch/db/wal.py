"""Durability: per-worker write-ahead logs + fuzzy checkpoints (§4.5.1, §5),
port of ``repro.db.wal`` with the same on-disk format.

The port keeps TID words as int64 on the card; they go to disk as uint32,
as the reference writes them (``append``, ``append_index_ops``,
``ckpt_tid.npy`` and the index checkpoints), so a directory the port writes
is byte-equal to the one the reference writes from the same epochs, and
either package recovers it.  ``recover_full`` widens them back to int64
(``convert.from_jax_state``) and replays on ``device`` — on the card the
record chunks merge through the ``thomas_merge`` kernel and the index
chunks through ``index_merge``; without a card it raises unless the caller
asks for the CPU.

Two record kinds per log entry:

* ``KIND_RECORD`` — (key, value words, TID).  Operation-replication
  messages are transformed before logging: the op is applied first and the
  WHOLE record value is logged (paper §5), so recovery can replay record
  chunks in ANY order under the Thomas write rule.
* ``KIND_INDEX`` — the ordered-index maintenance op stream
  (step, kind, IX_* operand columns, TID).  Index ops are NOT
  Thomas-mergeable: recovery replays each file's index chunks in file
  order, step-group by step-group, exactly once (strictly after the
  checkpoint epoch).  A partition's index ops all land in its owner's
  file, so chunks from different files touch disjoint segments and
  commute — per-file order is the only order that matters.

Checkpoints are fuzzy for records (the checkpointer scans (value, TID)
while writers proceed; over-replay is idempotent under the Thomas rule)
and epoch-aligned for indexes (the index arrays are snapshotted at the
commit fence of e_c and index chunks replay only for epochs > e_c —
exactly-once, since double-applying an insert would duplicate the key).
``recover`` / ``recover_full`` are exercised by tests end-to-end
(crash -> reload -> bit-identical state, indexes included).
"""
from __future__ import annotations

import json
import os
import struct
from pathlib import Path

import numpy as np
import torch

from repro_torch.convert import from_jax_state

HEADER = struct.Struct("<BIIQ")    # kind, n_entries, n_cols, epoch
KIND_RECORD = 0
KIND_INDEX = 1
MAGIC = b"WAL2"                    # format marker: refuses pre-v2 files
                                   # instead of mis-parsing them on resume


def _host(a):
    """A tensor (any device) or array-like as a numpy array."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _u32(a):
    """TID words as the reference's uint32 (int64 words are range-checked
    first)."""
    a = _host(a)
    if a.dtype != np.uint32 and a.size and (a.min() < 0
                                            or a.max() >= 1 << 32):
        raise ValueError("TID word outside [0, 2**32)")
    return a.astype(np.uint32)


class WriteAheadLog:
    def __init__(self, directory: str | Path, worker_id: int = 0):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / f"wal_{worker_id:03d}.log"
        fresh = not self.path.exists() or self.path.stat().st_size == 0
        if not fresh:
            # resume-after-crash appends to the existing file: refuse a
            # pre-v2 log NOW rather than corrupting it and only finding
            # out at recovery time (the one moment the WAL matters)
            with open(self.path, "rb") as fh:
                if fh.read(len(MAGIC)) != MAGIC:
                    raise ValueError(
                        f"{self.path}: not a {MAGIC.decode()} write-ahead "
                        "log — refusing to append to a pre-v2 file; start "
                        "a fresh log directory")
        self._fh = open(self.path, "ab")
        if fresh:
            self._fh.write(MAGIC)
            self._fh.flush()
        self.pending_rows: list[np.ndarray] = []
        self.pending_vals: list[np.ndarray] = []
        self.pending_tids: list[np.ndarray] = []
        self.pending_idx: list[tuple] = []     # (step, kinds, delta, tids)

    def append(self, rows, vals, tids, write_mask):
        """Buffer committed writes (arrays of any shape; mask selects)."""
        m = _host(write_mask).astype(bool).reshape(-1)
        rows = _host(rows).reshape(-1)[m]
        vals = _host(vals)
        vals = vals.reshape(-1, vals.shape[-1])[m]
        tids = _host(tids).reshape(-1)[m]
        if rows.size:
            self.pending_rows.append(rows.astype(np.int64))
            self.pending_vals.append(vals.astype(np.int32))
            self.pending_tids.append(_u32(tids))

    def append_index_ops(self, step, kinds, delta, tids):
        """Buffer one committed index-op stream chunk (flat, step-major —
        see ``replication.wal_index_streams``)."""
        step = _host(step).astype(np.int32).reshape(-1)
        if step.size:
            self.pending_idx.append(
                (step, _host(kinds).astype(np.int32).reshape(-1),
                 _host(delta).astype(np.int32).reshape(step.size, -1),
                 _u32(tids).reshape(-1)))

    def flush(self, epoch: int):
        """Periodic flush; also called inside the replication fence."""
        n_total = 0
        wrote = False
        if self.pending_rows:
            rows = np.concatenate(self.pending_rows)
            vals = np.concatenate(self.pending_vals)
            tids = np.concatenate(self.pending_tids)
            self._fh.write(HEADER.pack(KIND_RECORD, len(rows),
                                       vals.shape[1], epoch))
            self._fh.write(rows.tobytes())
            self._fh.write(vals.tobytes())
            self._fh.write(tids.tobytes())
            n_total += len(rows)
            wrote = True
            self.pending_rows, self.pending_vals, self.pending_tids = \
                [], [], []
        if self.pending_idx:
            step = np.concatenate([c[0] for c in self.pending_idx])
            kinds = np.concatenate([c[1] for c in self.pending_idx])
            delta = np.concatenate([c[2] for c in self.pending_idx])
            tids = np.concatenate([c[3] for c in self.pending_idx])
            self._fh.write(HEADER.pack(KIND_INDEX, len(step),
                                       delta.shape[1], epoch))
            self._fh.write(step.tobytes())
            self._fh.write(kinds.tobytes())
            self._fh.write(delta.tobytes())
            self._fh.write(tids.tobytes())
            n_total += len(step)
            wrote = True
            self.pending_idx = []
        if wrote:
            self._fh.flush()
            os.fsync(self._fh.fileno())
        return n_total

    def close(self):
        self._fh.close()

    @staticmethod
    def read_entries(path: Path, since_epoch: int = 0):
        """Record chunks (Thomas-mergeable post-images) at/after
        ``since_epoch``, in file order."""
        return [payload for kind, epoch, payload in
                WriteAheadLog.read_all(path)
                if kind == KIND_RECORD and epoch >= since_epoch]

    @staticmethod
    def read_all(path: Path):
        """Every entry as (kind, epoch, payload) in file order.  Record
        payload: (rows, vals, tids); index payload:
        (step, kinds, delta, tids)."""
        out = []
        raw = Path(path).read_bytes()
        if not raw:
            return out
        if raw[:len(MAGIC)] != MAGIC:
            raise ValueError(
                f"{path}: not a {MAGIC.decode()} write-ahead log — the "
                "file predates the record-kind format (re-parse would "
                "reconstruct garbage); start a fresh log directory")
        off = len(MAGIC)
        while off < len(raw):
            kind, n, c, epoch = HEADER.unpack_from(raw, off)
            off += HEADER.size
            if kind == KIND_RECORD:
                rows = np.frombuffer(raw, np.int64, n, off); off += 8 * n
                vals = np.frombuffer(raw, np.int32, n * c, off).reshape(n, c)
                off += 4 * n * c
                tids = np.frombuffer(raw, np.uint32, n, off); off += 4 * n
                out.append((kind, epoch, (rows, vals, tids)))
            else:
                step = np.frombuffer(raw, np.int32, n, off); off += 4 * n
                kinds = np.frombuffer(raw, np.int32, n, off); off += 4 * n
                delta = np.frombuffer(raw, np.int32, n * c, off).reshape(n, c)
                off += 4 * n * c
                tids = np.frombuffer(raw, np.uint32, n, off); off += 4 * n
                out.append((kind, epoch, (step, kinds, delta, tids)))
        return out


def write_checkpoint(directory: str | Path, val: np.ndarray, tid: np.ndarray,
                     epoch: int, indexes=None):
    """Fuzzy checkpoint: records e_c; logs earlier than e_c become dead.
    ``indexes`` (optional list of {"key","prow","tid"}) snapshot alongside
    — index chunks replay strictly AFTER e_c (exactly-once), so the index
    arrays must be the state at e_c's commit fence.  Tensors are brought
    to the host; TID words are written as uint32."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    np.save(d / "ckpt_val.npy", _host(val))
    np.save(d / "ckpt_tid.npy", _u32(tid))
    n_idx = 0 if indexes is None else len(indexes)
    for i in range(n_idx):
        for fld in ("key", "prow", "tid"):
            a = indexes[i][fld]
            np.save(d / f"ckpt_idx{i}_{fld}.npy",
                    _u32(a) if fld == "tid" else _host(a))
    (d / "ckpt_meta.json").write_text(
        json.dumps({"epoch": int(epoch), "n_indexes": n_idx}))


def recover(directory: str | Path, shuffle_seed: int | None = None,
            device=None):
    """Load checkpoint + replay all record WAL chunks since e_c with the
    Thomas rule.  Returns (val, tid, epoch) — records only, tensors on
    ``device`` (``None`` = cuda); index-aware callers use
    :func:`recover_full`.

    ``shuffle_seed`` permutes the replay order of every (file, flush-chunk)
    pair before applying — the Thomas rule makes record recovery order-free
    (each entry is a whole-record post-image tagged with its commit TID,
    whose epoch lives in the high bits), so any permutation must produce
    the identical state; tests exercise this directly."""
    val, tid, _, epoch = recover_full(directory, shuffle_seed=shuffle_seed,
                                      device=device)
    return val, tid, epoch


def iter_changelog(directory: str | Path, since_epoch: int = 0):
    """The durable changelog as an ordered stream source: every surviving
    entry across the per-worker logs, yielded as ``(kind, epoch, payload)``
    with kind ``"record"`` or ``"index"``, per-file in file order (the only
    order the stream guarantees — cross-file chunks commute by
    construction).

    The two kinds carry the stream's two ordering disciplines past a
    checkpoint at ``since_epoch``: record chunks are Thomas-mergeable
    post-images and replay for every epoch AT or after it (over-replay of
    the checkpointed epoch is idempotent under the Thomas rule — the fuzzy
    checkpoint may straddle it), while index chunks replay exactly-once
    and only STRICTLY after it (the checkpointed index arrays already
    contain ``since_epoch``)."""
    d = Path(directory)
    for wal in sorted(d.glob("wal_*.log")):
        for kind, epoch, payload in WriteAheadLog.read_all(wal):
            if kind == KIND_RECORD and epoch >= since_epoch:
                yield "record", epoch, payload
            elif kind == KIND_INDEX and epoch > since_epoch:
                yield "index", epoch, payload


def recover_full(directory: str | Path, shuffle_seed: int | None = None,
                 device=None):
    """Checkpoint + replay of the durable changelog, indexes included.
    Returns (val, tid, indexes | None, epoch) as tensors on ``device``
    (``None`` = cuda; raises without a card), TID words int64.

    Record chunks Thomas-merge in any order (``shuffle_seed`` exercises
    that) through ``replication.thomas_apply``; index chunks replay per file
    in file order through ``storage.index.apply_index_ops``, grouped by
    their step ids, only for epochs strictly after the checkpoint epoch
    (exactly-once — the checkpointed index arrays already contain e_c).
    Both arrive through :func:`iter_changelog`."""
    from repro_torch.core.replication import thomas_apply
    from repro_torch.storage.index import apply_index_ops
    d = Path(directory)
    meta = json.loads((d / "ckpt_meta.json").read_text())
    e_c = meta["epoch"]
    n_idx = int(meta.get("n_indexes", 0))
    ckpt = [{fld: np.load(d / f"ckpt_idx{i}_{fld}.npy")
             for fld in ("key", "prow", "tid")} for i in range(n_idx)]
    st = from_jax_state(np.load(d / "ckpt_val.npy"),
                        np.load(d / "ckpt_tid.npy"), ckpt, device=device)
    val, tid = st["val"], st["tid"]
    indexes = st["indexes"] if n_idx else None
    dev = val.device
    shape = val.shape
    fval = val.reshape(-1, shape[-1])
    ftid = tid.reshape(-1)
    chunks, idx_chunks = [], []
    for kind, epoch, payload in iter_changelog(d, since_epoch=e_c):
        if kind == "record":
            chunks.append(payload)
        else:
            idx_chunks.append((epoch, payload))
    if shuffle_seed is not None:
        np.random.default_rng(shuffle_seed).shuffle(chunks)

    def dv(a, dtype):
        return torch.as_tensor(np.asarray(a).astype(dtype), device=dev)
    for rows, vals, tids in chunks:
        thomas_apply(fval, ftid, dv(rows, np.int32), dv(vals, np.int32),
                     dv(tids, np.int64))
    if indexes is not None:
        # per-file order is already epoch-ascending; replay each chunk's
        # step groups in order (ops within a step group commuted live)
        for _, (step, kinds, delta, tids) in idx_chunks:
            for s in np.unique(step):          # np.unique sorts ascending
                m = step == s
                indexes, _ = apply_index_ops(
                    indexes, dv(kinds[m], np.int32), dv(delta[m], np.int32),
                    torch.ones(int(m.sum()), dtype=torch.bool, device=dev),
                    dv(tids[m], np.int64))
    return (fval.reshape(shape), ftid.reshape(shape[:-1]), indexes, e_c)


# ---------------------------------------------------------------------------
# live-execution durability: per-worker WALs + checkpoint cadence
# ---------------------------------------------------------------------------
class Durability:
    """Drives the dormant WAL/checkpoint machinery from live execution.

    One instance serves one engine (single-host ``StarEngine`` or one
    ``ClusterRuntime``): each worker (paper: node; here: partition group)
    appends its committed value stream — and, for index-bearing workloads,
    its ordered index-op stream — to its own ``WriteAheadLog``, all logs
    flush inside the epoch's commit fence, and every ``checkpoint_every``
    epochs the committed state is checkpointed (fuzzily for records;
    epoch-aligned index arrays ride along so index replay stays
    exactly-once).  An epoch-0 checkpoint of the initial state is written
    at attach time so recovery works before the first cadence checkpoint.

    TID epochs are 8 bits (``core.tid``): log retention beyond 255 epochs
    past the checkpoint would alias the Thomas ordering, so the cadence
    must stay well below that — asserted here.
    """

    def __init__(self, directory: str | Path, n_workers: int = 1,
                 checkpoint_every: int = 8, worker: int | None = None):
        """``worker``: the one worker whose log this process writes (a
        node of the cluster with one process a node); None: all of
        them."""
        assert 0 < checkpoint_every < 200, checkpoint_every
        self.dir = Path(directory)
        self.n_workers = n_workers
        self.checkpoint_every = checkpoint_every
        self.worker = worker
        self.wals = [WriteAheadLog(self.dir, w)
                     if worker is None or w == worker else None
                     for w in range(n_workers)]
        self.entries_logged = 0
        self.checkpoints = 0
        self.last_ckpt_epoch = 0

    def attach(self, val, tid, indexes=None):
        """Write the epoch-0 baseline checkpoint of the initial state —
        unless the directory already holds one (an engine resuming after a
        crash keeps the existing checkpoint + logs: recovery replays from
        the recorded e_c, and overwriting with the fresh engine's initial
        state would discard the durable history)."""
        if not (self.dir / "ckpt_meta.json").exists():
            write_checkpoint(self.dir, val, tid, 0, indexes=indexes)

    def log(self, worker: int, rows, vals, tids, write_mask):
        """Buffer one committed write stream chunk (global flat rows)."""
        wal = self.wals[worker % self.n_workers]
        if wal is not None:
            wal.append(rows, vals, tids, write_mask)

    def log_epoch_streams(self, plog, slog, R: int, C: int,
                          worker_of_partition, cross_kinds=None,
                          cross_delta=None, part_ids=None):
        """Fan one committed epoch's streams out to the per-worker logs:
        the partitioned op stream in its §5 transformed form, the master's
        value stream split by row owner, and — when the logs carry index
        maintenance — the ordered index-op stream split by segment owner
        (see ``replication.wal_partition_streams`` /
        ``wal_master_streams`` / ``wal_index_streams``).
        ``worker_of_partition``: (P,) int map — ``p % n_workers`` on the
        single-host engine, ``p // ppn`` on the cluster's node blocks.
        ``cross_kinds``/``cross_delta``: the single-master batch's static
        op arrays (index-op recovery re-applies (kind, operand), which the
        SM log itself does not carry).  ``part_ids``: the global partition
        ids of plog's rows, where plog holds one node's block (the cluster
        with one process a node)."""
        from repro_torch.core import replication as repl
        if plog is not None:
            for w, rows, vals, tids, mask in repl.wal_partition_streams(
                    plog, R, self.n_workers, worker_of_partition,
                    part_ids=part_ids):
                self.log(w, rows, vals, tids, mask)
        if slog is not None:
            for w, rows, vals, tids, mask in repl.wal_master_streams(
                    slog, R, C, self.n_workers, worker_of_partition):
                self.log(w, rows, vals, tids, mask)
        has_pidx = plog is not None and "iwrite" in plog
        has_sidx = slog is not None and "iwrite" in slog \
            and cross_kinds is not None
        if has_pidx or has_sidx:
            for w, step, kinds, delta, tids in repl.wal_index_streams(
                    plog if has_pidx else None, self.n_workers,
                    worker_of_partition, cross_kinds=cross_kinds,
                    cross_delta=cross_delta,
                    slog=slog if has_sidx else None, part_ids=part_ids):
                wal = self.wals[w % self.n_workers]
                if wal is not None:
                    wal.append_index_ops(step, kinds, delta, tids)

    def commit_epoch(self, epoch: int, val=None, tid=None,
                     indexes=None) -> int:
        """Inside the commit fence: fsync every worker's log; on cadence,
        also checkpoint the (committed) state passed in.  Returns the
        number of entries flushed."""
        n = sum(w.flush(epoch) for w in self.wals if w is not None)
        self.entries_logged += n
        if val is not None and epoch - self.last_ckpt_epoch >= \
                self.checkpoint_every:
            write_checkpoint(self.dir, val, tid, epoch, indexes=indexes)
            self.checkpoints += 1
            self.last_ckpt_epoch = epoch
        return n

    def close(self):
        for w in self.wals:
            if w is not None:
                w.close()


class WalSink:
    """ChangeLog subscriber: WAL appends as a changelog sink.

    At every commit fence the changelog hands over the whole epoch's
    record — the partitioned op stream (already §5-transformed to
    post-images), the single-master stream, and the batch's static index
    op arrays — and the sink fans it to the per-worker logs and group-
    commits them (flush + fsync + cadence checkpoint) inside the fence.
    ``snapshot_provider`` returns the engine's committed
    ``(val, tid, indexes | None)`` tensors for the cadence checkpoint;
    they come to the host (``.cpu()``) only when one is written.

    Doomed epochs never reach ``on_commit`` (the engine reverts instead
    of committing), so the durable stream only ever contains committed
    slabs — exactly the pre-refactor behavior.
    """

    def __init__(self, durability: Durability, R: int, C: int,
                 worker_of_partition, snapshot_provider, part_ids=None):
        """``part_ids``: the global partition ids of the partitioned log's
        rows, where the engine's log holds one node's block."""
        self.d = durability
        self.R, self.C = int(R), int(C)
        self.worker_of_partition = np.asarray(worker_of_partition)
        self.snapshot_provider = snapshot_provider
        self.part_ids = part_ids

    def on_commit(self, epoch, record):
        from repro_torch.obs import trace as obs
        with obs.span("fence.wal_sink", cat="fence", epoch=int(epoch)):
            self.d.log_epoch_streams(record["part"], record["sm"],
                                     self.R, self.C,
                                     self.worker_of_partition,
                                     cross_kinds=record["cross_kinds"],
                                     cross_delta=record["cross_delta"],
                                     part_ids=self.part_ids)
            val, tid, indexes = self.snapshot_provider()
            self.d.commit_epoch(epoch, val, tid, indexes=indexes)
