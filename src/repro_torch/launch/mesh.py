"""Process groups and meshes, the counterpart of ``repro/launch/mesh.py``.

The JAX package lays its devices out on a named mesh; here a rank of a
``torch.distributed`` process group takes a device's place, and a
:class:`Mesh` names the ranks' layout and gives each axis's process group
(built on :func:`torch.distributed.device_mesh.init_device_mesh`).  A mesh
of one rank needs no process group: every tensor on it is whole.  Nothing
here touches ``torch.distributed`` at import time.

The backend rule (:func:`choose_backend`), stated once and never switched
after a failure:

* ``gloo`` for CPU tensors;
* ``nccl`` when each rank has a card of its own;
* ``gloo`` on CUDA tensors when several ranks share one card, because
  NCCL refuses two ranks on one GPU.

:func:`spawn` runs a function on N ranks in N fresh processes, bounded:
the ranks meet through a ``FileStore`` in a directory of the caller's,
each runs torch on ``threads`` intra-op threads, the group's collectives
time out after ``group_timeout_s``, and the parent kills every child at
its deadline.  A failing rank fails the call.
"""
from __future__ import annotations

import math
import os
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import torch


def choose_backend(device, world_size: int) -> str:
    """The backend for ``world_size`` ranks whose tensors live on
    ``device`` (module docstring)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= world_size else "gloo"


def init_process_group(rank: int, world_size: int, init_method: str,
                       device, timeout_s: float = 60.0, verbose: bool = True):
    """Join the default process group by :func:`choose_backend`'s rule.
    Returns (backend, this rank's device).  With ``nccl`` rank r takes
    card r; with ``gloo`` on CUDA every rank takes ``device`` (one card
    shared)."""
    import torch.distributed as dist
    dev = torch.device(device)
    backend = choose_backend(dev, world_size)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: device 'cuda' requested but "
                               "torch.cuda is not available")
        if backend == "nccl":
            dev = torch.device("cuda", rank)
        elif dev.index is None:
            dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(seconds=timeout_s))
    if verbose and rank == 0:
        print(f"torch.distributed: backend {backend}, {world_size} ranks, "
              f"tensors on {dev.type}", flush=True)
    return backend, dev


class AbstractMesh:
    """Axis names and sizes with no process group: what the placement rules
    of ``launch/sharding.py`` read (the counterpart of
    ``jax.sharding.AbstractMesh``).  With ``coords`` ({axis: index}) it
    also says which shard :func:`~repro_torch.launch.sharding.place` cuts
    for that position."""

    distributed = False

    def __init__(self, shape, axis_names, coords=None):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        assert len(shape) == len(axis_names), (shape, axis_names)
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.size = math.prod(shape)
        self.coords = dict(coords) if coords is not None else None

    def index(self, axes) -> int:
        """This position's row-major index over ``axes`` (a name or a
        tuple)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def count(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape[a] for a in axes)

    def __repr__(self):
        return f"{type(self).__name__}({self.shape})"


class Mesh(AbstractMesh):
    """A named layout of the group's ranks, row-major over ``axis_names``
    as ``jax.make_mesh`` lays devices out.  Its size is the world size, or
    1: a one-rank mesh is local to each process (no group; every tensor on
    it whole).  ``coords[axis]`` is this rank's index on an axis and
    ``group(axis)`` the group of the ranks that differ from it on that
    axis alone."""

    def __init__(self, shape, axis_names):
        super().__init__(shape, axis_names)
        self.device_mesh = None
        self._groups: dict = {}
        if self.size == 1:
            self.rank = 0
            self.coords = {a: 0 for a in self.axis_names}
            return
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        if not dist.is_initialized():
            raise RuntimeError(f"a mesh of {self.size} ranks needs an "
                               "initialised process group")
        world = dist.get_world_size()
        if world != self.size:
            raise RuntimeError(f"mesh {tuple(self.shape.values())} needs "
                               f"{self.size} ranks, the group has {world}")
        # the device mesh's type names where its tensors live; the groups
        # are the default group's backend either way
        dtype = "cuda" if dist.get_backend() == "nccl" else "cpu"
        self.device_mesh = init_device_mesh(
            dtype, tuple(self.shape.values()), mesh_dim_names=self.axis_names)
        self.rank = dist.get_rank()
        coord = self.device_mesh.get_coordinate()
        self.coords = dict(zip(self.axis_names, coord))
        self._groups = {a: self.device_mesh.get_group(a)
                        for a in self.axis_names}

    @property
    def distributed(self) -> bool:
        return self.size > 1

    def group(self, axis: str):
        """The process group of ``axis`` (None on a one-rank mesh)."""
        return self._groups.get(axis)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) with "pod" first:
    one rank a device of the reference's layout."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    import torch.distributed as dist
    found = dist.get_world_size() if dist.is_initialized() else 1
    if found < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, found {found} — start {n} "
            "ranks of one process group (launch/mesh.py::spawn) first")
    return Mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A (data, model) mesh over the process group's ranks (tests,
    examples); (1, 1) needs no group."""
    return Mesh((data, model), ("data", "model"))


# ---------------------------------------------------------------------------
# bounded multi-process runs
# ---------------------------------------------------------------------------
def _rank_main(rank, fn, world_size, init_method, device, out_dir, args,
               threads, group_timeout_s):
    import torch.distributed as dist
    torch.set_num_threads(threads)
    _, dev = init_process_group(rank, world_size, init_method, device,
                                timeout_s=group_timeout_s)
    try:
        result = fn(rank, world_size, dev, *args)
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, args=(), device=None, timeout_s=120.0,
          workdir=None, threads: int = 1, group_timeout_s: float = 60.0):
    """Run ``fn(rank, world_size, device, *args)`` on ``world_size`` ranks,
    one fresh process each (start method ``spawn``: CUDA does not survive
    ``fork``), and return the ranks' results in rank order (each saved
    with ``torch.save``).  ``fn`` must be importable by name.  ``device``:
    ``None``/``"cuda"`` (raises here without a card) or ``"cpu"``.
    Raises if a rank raises (with its traceback) or if the ranks are not
    done within ``timeout_s``; every child is gone when this returns."""
    import torch.multiprocessing as mp
    from repro_torch.device import resolve_device
    device = resolve_device(device).type
    own = workdir is None
    tmp = tempfile.TemporaryDirectory() if own else None
    work = Path(tmp.name if own else workdir)
    work.mkdir(parents=True, exist_ok=True)
    store = work / f"store-{os.getpid()}-{time.monotonic_ns()}"
    out = work / store.name.replace("store", "out")
    out.mkdir()
    try:
        ctx = mp.start_processes(
            _rank_main, nprocs=world_size, join=False, start_method="spawn",
            args=(fn, world_size, f"file://{store}", str(device), str(out),
                  tuple(args), threads, group_timeout_s))
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=0.5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks of {fn.__name__}"
                                       f" not done within {timeout_s:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(out / f"rank{r}.pt", weights_only=False)
                for r in range(world_size)]
    finally:
        if own:
            tmp.cleanup()
