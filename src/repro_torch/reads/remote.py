"""Reads served by the rank that holds the copy: the read round of the
cluster with one process a node (``core.cluster.DistClusterStarEngine``).

With one process a node the read tier runs on the master (rank 0), whose
memory holds the full copy and node 0's secondary copy; node m's
secondary copy (node m-1's partitions) lives on rank m.  The master's
:class:`~repro_torch.reads.catalog.SnapshotCatalog` keeps an entry for
every copy with the single-process metadata, but for a copy on another
rank it holds no tensors, only the hosting rank: a group the tier sends
to ``sec{m}`` travels to rank m, which answers it from its own retained
snapshot through the same :class:`SnapshotReadExecutor`, and the result
travels back.

* :class:`ReadHost` — the serving side on a rank other than the master:
  the ring of this rank's own secondary snapshots (one copy a stamped
  fence, kept exactly as long as the master's catalog keeps that
  entry's snapshot) and the executor.
* :class:`RemoteReads` — the master's side: ring syncs after the
  catalog's stamp / announce / remove decisions, and remote groups.

Every message is point to point (``_Comm.send_obj`` / ``recv_obj``: a
pickled request and a pickled reply).  Two kinds of round:

* **at the fence** (between epochs) the other ranks wait for the next
  epoch's broadcast; the master opens a round with that broadcast
  (``{"op": "reads"}``), sends its requests, and closes it with an END to
  every rank;
* **mid-epoch** (the service's ingest hook, during the partitioned phase)
  the other ranks poll for a request at every slab boundary and, after
  their last slab, answer until the master's END: the phase stays free
  of collective calls.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.obs import trace as obs
from repro_torch.reads.catalog import snapshot_copy
from repro_torch.reads.executor import SnapshotReadExecutor

TAG = 300                 # requests use TAG and TAG + 1, replies TAG + 2
END, RING, READ = "end", "ring", "read"


class ReadHost:
    """The serving side of one rank: ``ring`` {epoch: snapshot} of this
    rank's secondary copy, the executor, and what it served (``groups``,
    ``reads``, ``launches``: the executor's kernel dispatches by name)."""

    def __init__(self, eng):
        self.eng = eng
        self.ring: dict = {}
        self.executor = SnapshotReadExecutor()
        self.groups = 0
        self.reads = 0
        self.serve_s = 0.0
        self.launches: dict = {}
        self._pending = None

    # -- one request --------------------------------------------------------
    def _handle(self, req: dict) -> bool:
        """Serve one request; False at END."""
        op = req["op"]
        if op == END:
            return False
        if op == RING:
            self._sync(req["keep"])
        elif op == READ:
            self._read(req)
        else:
            raise ValueError(f"unknown read request {op!r}")
        return True

    def _sync(self, keep):
        """Keep the snapshots of ``keep`` (a new one is this rank's
        committed secondary copy, taken now, at its fence)."""
        eng = self.eng
        for e in keep:
            if e in self.ring:
                continue
            if e != eng.committed_epoch:
                raise RuntimeError(f"rank {eng.rank}: asked to keep the "
                                   f"snapshot of epoch {e}, which it never "
                                   f"took (committed: {eng.committed_epoch})")
            self.ring[e] = snapshot_copy(*eng.secondary_snapshot())
        for e in [e for e in self.ring if e not in keep]:
            del self.ring[e]

    def _read(self, req):
        t0 = time.perf_counter()
        before = obs.kernel_launch_counts()
        out = self.executor.run(self.ring[req["epoch"]], req["arow"],
                                req["rows"], req["kinds"], req["deltas"])
        after = obs.kernel_launch_counts()
        for k, n in after.items():
            if n != before.get(k, 0):
                self.launches[k] = self.launches.get(k, 0) + n \
                    - before.get(k, 0)
        reply = {k: v.cpu().numpy() for k, v in out.items()}
        self.eng.comm.send_obj(reply, 0, TAG + 2)
        self.groups += 1
        self.reads += int(req["arow"].shape[0])
        self.serve_s += time.perf_counter() - t0

    def _recv(self):
        return self.eng.comm.recv_obj(0, TAG)

    # -- at the fence -------------------------------------------------------
    def answer_round(self):
        """Serve the master's requests until its END."""
        while self._handle(self._recv()):
            pass

    # -- mid-epoch ----------------------------------------------------------
    def phase_begin(self):
        """The partitioned phase starts: listen for a request."""
        self._pending = self.eng.comm.post_obj(0, TAG)

    def poll(self, wait: bool = False):
        """Serve the requests that have arrived (at a slab boundary), or
        with ``wait`` every request until the master's END (after the last
        slab).  The END may come at a slab boundary already: the master
        sends it once its own ingest hook is done, which a slower rank may
        not yet have reached the end of its phase by."""
        c = self.eng.comm
        while self._pending is not None and (wait or self._pending.done()):
            req = self._pending.take()
            self._pending = None
            if self._handle(req):
                self._pending = c.post_obj(0, TAG)


class RemoteReads:
    """The master's side of the read round (module docstring).

    ``stats[mode]`` ("fence" / "mid_epoch"): remote ``groups`` and
    ``reads``, ring ``syncs`` and the seconds the master spent on them
    (``s``: request to reply); ``rounds``: fence rounds opened."""

    def __init__(self, eng):
        self.eng = eng
        self.kept: dict = {}          # host rank -> last keep list sent
        self._open = False
        self.rounds = 0
        self.stats = {m: {"groups": 0, "reads": 0, "syncs": 0, "s": 0.0}
                      for m in ("fence", "mid_epoch")}

    def _send(self, host: int, req: dict) -> str:
        """Send one request (opening a fence round first if none is open);
        returns its round."""
        mode = self.eng.read_mode()
        if mode == "fence" and not self._open:
            self.eng.open_read_round()
            self._open = True
            self.rounds += 1
        self.eng.comm.send_obj(req, host, TAG)
        return mode

    def sync_rings(self, keeps: dict):
        """{host rank: the epochs its catalog entry keeps}: each host whose
        list changed takes its new snapshot and drops the others."""
        for host, keep in sorted(keeps.items()):
            keep = [int(e) for e in keep]
            if self.kept.get(host) == keep:
                continue
            t0 = time.perf_counter()
            mode = self._send(host, {"op": RING, "keep": keep})
            self.kept[host] = keep
            st = self.stats[mode]
            st["syncs"] += 1
            st["s"] += time.perf_counter() - t0

    def read(self, host: int, epoch: int, arow, rows, kinds, deltas) -> dict:
        """One group served by rank ``host`` from its snapshot of
        ``epoch``; the outputs as tensors on the master's device."""
        t0 = time.perf_counter()
        mode = self._send(host, {"op": READ, "epoch": int(epoch),
                                 "arow": np.asarray(arow, np.int64),
                                 "rows": np.asarray(rows, np.int64),
                                 "kinds": np.asarray(kinds, np.int32),
                                 "deltas": np.asarray(deltas, np.int64)})
        got = self.eng.comm.recv_obj(host, TAG + 2)
        dev = self.eng.device
        out = {k: torch.as_tensor(v, device=dev) for k, v in got.items()}
        st = self.stats[mode]
        st["groups"] += 1
        st["reads"] += int(np.asarray(arow).shape[0])
        st["s"] += time.perf_counter() - t0
        return out

    def close(self):
        """End a fence round (a no-op when none is open)."""
        if self._open:
            self.end_phase()
            self._open = False

    def end_phase(self):
        """END to every other rank: the engine calls it after the
        partitioned phase's ingest hook, and :meth:`close` at the fence."""
        c = self.eng.comm
        for r in range(1, self.eng.n_nodes):
            c.send_obj({"op": END}, r, TAG)
