"""The dry run of every (arch x shape x mesh) cell, the counterpart of
``repro/launch/dryrun.py``: what one rank of the production mesh holds,
with no process group and no allocation.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

The reference lowers and compiles each cell's jitted step for 512
placeholder devices and reads XLA's memory and cost analyses.  Here each
cell's bundle (``launch/steps.py::bundle_for``) builds its trees on the
``meta`` device and places them with the rules of
``launch/sharding.py`` on an :class:`~repro_torch.launch.mesh.AbstractMesh`
of the production shape ((16, 16) over (data, model), or (2, 16, 16)
with pod first).  For each cell it records:

* the skip decision of ``configs.base.cell_applicable``;
* the bytes of one rank's shard of each tree (parameters, optimizer
  state, batch, cache): every rank holds the same bytes, because the rules
  shard a dimension only where its axes divide it;
* whether they fit in one H100's memory (:data:`FIT_LIMIT_BYTES`, the
  reference's 16 GiB in its place), and whether they would with every
  parameter whole, as a rank of the port holds them while it runs a step
  (the tensor-parallel split of the dense layers is not reproduced; the
  rules still place the stored shards): then a train step also holds
  whole gradients (:func:`grad_bytes_whole`);
* the roofline terms of ``launch/roofline.py``.

Temporary (activation) bytes are recorded as None: XLA reports them for
the compiled program, and without running the step there is nothing that
measures them.  Records go to ``results/dryrun_torch/`` (not tracked).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import torch

from repro_torch.configs.base import (ALL_ARCHS, SHAPES, cell_applicable,
                                      get_arch)
from repro_torch.launch import roofline as rl
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.steps import bundle_for

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

#: ``torch.cuda.get_device_properties(0).total_memory`` of the NVIDIA H100
#: 80GB HBM3 that ``chip_smoke.py`` runs on, read there
FIT_LIMIT_BYTES = 85_017_493_504

TEMP_NOTE = ("activation bytes of a step need the step run; the dry run "
             "allocates nothing")


def production_mesh(multi_pod: bool) -> AbstractMesh:
    """The reference's production layout, with no ranks behind it."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def cell_path(arch: str, shape: str, multi_pod: bool) -> Path:
    return RESULTS / f"{arch}__{shape}__{mesh_name(multi_pod)}.json"


def shard_bytes(t, spec: tuple, mesh) -> int:
    """Bytes of one rank's shard of ``t`` (a tensor) under ``spec``."""
    n = t.element_size()
    for d, s in enumerate(tuple(t.shape)):
        axes = shd.axes_of(spec[d]) if d < len(spec) else ()
        k = mesh.count(axes) if axes else 1
        if s % k:
            raise ValueError(f"dimension {d} of {tuple(t.shape)} does not "
                             f"split over {axes} ({k} ways)")
        n *= s // k
    return n


def tree_bytes(tree, specs, mesh) -> int:
    """One rank's bytes of a tree of tensors (ints, such as a cache's
    position, hold no device memory)."""
    spec_of = dict(shd._flatten(specs))
    return sum(shard_bytes(t, spec_of[name], mesh)
               for name, t in shd._flatten(tree)
               if isinstance(t, torch.Tensor))


def grad_bytes_whole(params: dict) -> int:
    """The most bytes of whole gradients a rank holds in a train step on a
    mesh of several ranks (``launch/steps.py::make_train_fn``): the
    gradients in the parameters' dtypes beside their float32 copy, then
    that copy beside the flat float32 buffer ``_all_reduce_flat`` sums
    (with microbatches the float32 sum beside one microbatch's gradients
    or its scaled copy: no more)."""
    n = sum(t.numel() for t in params.values())
    own = sum(t.numel() * t.element_size() for t in params.values())
    return max(own + 4 * n, 8 * n)


def cell_record(cfg, cell, mesh) -> dict:
    """The bytes a rank of ``mesh`` holds for one step of ``cell``, their
    fit under :data:`FIT_LIMIT_BYTES` and the roofline terms (``cfg`` and
    ``cell`` may be any config and cell: chip_smoke.py holds a trainer to
    it)."""
    b = bundle_for(cfg, cell, mesh)
    by_tree = {k: tree_bytes(t, b.specs[k], mesh) for k, t in b.trees.items()}
    args = sum(by_tree[k] for k in b.arguments)
    held = sum(by_tree.values())
    # the port runs each dense layer whole: a rank holds every parameter
    # (and, training, every gradient) while it runs a step, its shards of
    # the rest as placed
    params = b.trees["params"]
    whole = sum(t.numel() * t.element_size() for t in params.values())
    grads = grad_bytes_whole(params) if cell.kind == "train" else 0
    unsplit = held - by_tree["params"] + whole + grads
    roof = rl.derive(rl.model_flops_for(cfg, cell), args, mesh.size)
    return {"n_chips": mesh.size,
            "mesh": dict(mesh.shape),
            "mem": {"bytes_per_rank": by_tree,
                    "arguments": list(b.arguments),
                    "argument_bytes": args,
                    "output_bytes": held - args,
                    "held_bytes": held,
                    "temp_bytes": None, "temp_note": TEMP_NOTE,
                    "limit_bytes": FIT_LIMIT_BYTES,
                    "fits": bool(held <= FIT_LIMIT_BYTES),
                    "grad_bytes_whole": grads,
                    "held_bytes_whole_params": unsplit,
                    "fits_whole_params": bool(unsplit <= FIT_LIMIT_BYTES)},
            "roofline": roof.to_dict()}


def run_cell(arch: str, shape: str, multi_pod: bool,
             overrides: dict | None = None) -> dict:
    cfg = get_arch(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cell = SHAPES[shape]
    rec = {"arch": arch, "shape": shape, "multi_pod": multi_pod}
    ok, why = cell_applicable(cfg, cell)
    if not ok:
        return dict(rec, status="skipped", reason=why)
    return dict(rec, status="ok",
                **cell_record(cfg, cell, production_mesh(multi_pod)))


def run_all(archs=None, shapes=None, meshes=(False,),
            overrides: dict | None = None, out_dir: Path | None = None,
            echo=print) -> list:
    """Every cell of ``archs`` x ``shapes`` x ``meshes`` (all by default);
    each record is written to ``out_dir`` if one is given."""
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
    recs = []
    for multi_pod in meshes:
        for arch in archs or ALL_ARCHS:
            for shape in shapes or list(SHAPES):
                rec = run_cell(arch, shape, multi_pod, overrides)
                recs.append(rec)
                if out_dir is not None:
                    p = out_dir / cell_path(arch, shape, multi_pod).name
                    p.write_text(json.dumps(rec, indent=1))
                label = f"{arch} x {shape} x {mesh_name(multi_pod)}"
                if rec["status"] == "ok":
                    m, r = rec["mem"], rec["roofline"]
                    echo(f"{label}: {m['held_bytes'] / 2**30:.2f} GiB a "
                         f"rank (fits {m['fits']}), compute "
                         f"{r['compute_s'] * 1e3:.2f} ms, memory "
                         f"{r['memory_s'] * 1e3:.2f} ms -> "
                         f"{r['bottleneck']}")
                else:
                    echo(f"{label}: skipped ({rec['reason']})")
    return recs


def _overrides(pairs) -> dict:
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("True", "False"):
            v = v == "True"
        out[k] = v
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (int/float/bool parsed)")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch or args.shape):
        ap.error("name --arch and/or --shape, or --all")
    recs = run_all([args.arch] if args.arch else None,
                   [args.shape] if args.shape else None,
                   (False, True) if args.both_meshes else (args.multi_pod,),
                   _overrides(args.set) or None, out_dir=RESULTS)
    ok = [r for r in recs if r["status"] == "ok"]
    n_fit = sum(r["mem"]["fits"] for r in ok)
    split_only = sorted({f"{r['arch']} x {r['shape']}" for r in ok
                         if r["mem"]["fits"]
                         and not r["mem"]["fits_whole_params"]})
    print(f"dryrun summary: ok={len(ok)} skipped={len(recs) - len(ok)} "
          f"fit={n_fit} records={len(recs)} -> {RESULTS}")
    print(f"fit only with the tensor-parallel split: {split_only}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
