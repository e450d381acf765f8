"""Training command line:

    PYTHONPATH=src python -m repro_torch.launch.train --arch <id> [--smoke]
        [--steps N] [--seq S] [--batch B] [--ckpt DIR]
        [--steps-per-epoch K] [--device cuda|cpu]

Random weights from seed 0; the device defaults to cuda.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--steps-per-epoch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import get_arch
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_arch(args.arch, smoke=args.smoke)
    tr = Trainer(cfg, TrainerConfig(
        seq_len=args.seq, batch=args.batch, checkpoint_dir=args.ckpt,
        steps_per_epoch=args.steps_per_epoch), device=args.device)
    if args.ckpt:
        meta = tr.restore_from_disk()
        if meta:
            print(f"resumed from step {meta['step']}")
    for chunk in range(0, args.steps, args.steps_per_epoch):
        m = tr.run(min(args.steps_per_epoch, args.steps - chunk))
        print(f"step {m['step']:5d} loss {m['loss']:.4f} "
              f"ce {m['ce']:.4f} gnorm {m['grad_norm']:.3f}", flush=True)
    print(f"done on {tr.device}: {tr.step} steps, {tr.commit_log.fences} "
          f"epoch fences, {tr.straggler_events} straggler events")
    return tr


if __name__ == "__main__":
    main()
