"""Serving command line:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch <id> [--smoke]
        [--batch B] [--prompt-len S] [--gen N] [--device cuda|cpu]

Random weights from ``--seed``; the device defaults to cuda.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import ServeEngine

    cfg = get_arch(args.arch, smoke=args.smoke)
    if cfg.is_encoder:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode path")
    dev = resolve_device(args.device)
    eng = ServeEngine(cfg, LM(cfg, seed=args.seed, device=dev), device=dev,
                      max_len=args.prompt_len + args.gen)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev, dtype=torch.int32)
    out = eng.generate(prompts, args.gen)
    st = eng.stats
    print(f"{cfg.name} on {dev}: generated {tuple(out.shape)}; prefill "
          f"{st.prefill_tokens} tokens in {st.prefill_s:.3f}s, decode "
          f"{st.decode_steps} steps in {st.decode_s:.3f}s "
          f"({st.decoded_tokens / max(st.decode_s, 1e-9):.1f} tok/s)")
    print("first row:", out[0, :16].tolist())
    return out


if __name__ == "__main__":
    main()
