"""Roofline terms of a dry-run cell on H100 terms, the counterpart of
``repro/launch/roofline.py``.

compute term = model FLOPs / (chips * 989e12)
memory term  = bytes each rank must read at least once / 3.35e12

989 TFLOP/s is the H100 SXM's dense bf16 tensor-core peak and 3.35 TB/s
its HBM3 bandwidth: the peaks the port's kernel bounds use.  The memory
term is a LOWER bound from the arguments a rank holds (its shards of the
parameters, the optimizer state, the batch and the cache, read once);
the reference counts the traffic of the compiled, partitioned HLO
(``hlo_analysis``), loops and temporaries included, which has no
counterpart without a compiler.  There is no collective term
(``collective_s`` None): no link rate of a multi-card H100 machine has
been measured, and the machine the port is measured on has one card.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass

PEAK_FLOPS = 989e12        # bf16 FLOP/s per card, dense (H100 SXM)
HBM_BW = 3.35e12           # B/s per card (H100 SXM, HBM3)


@dataclass
class Roofline:
    model_flops: float             # 6*N*D (train) or 2*N*D, global
    n_chips: int
    bytes_per_device: float        # what each rank reads at least once
    compute_s: float
    memory_s: float
    collective_s: float | None     # not modelled (module docstring)
    bottleneck: str

    def to_dict(self):
        return asdict(self)


def derive(model_flops: float, bytes_per_device: float,
           n_chips: int) -> Roofline:
    compute_s = model_flops / (n_chips * PEAK_FLOPS)
    memory_s = bytes_per_device / HBM_BW
    return Roofline(model_flops=model_flops, n_chips=n_chips,
                    bytes_per_device=bytes_per_device, compute_s=compute_s,
                    memory_s=memory_s, collective_s=None,
                    bottleneck="compute" if compute_s >= memory_s
                    else "memory")


def model_flops_for(cfg, cell) -> float:
    """MODEL_FLOPS = 6*N*D for train (D = tokens per step), 2*N*D for
    forward-only steps (N: active parameters)."""
    n = cfg.n_active_params()
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                  else 1)
    mult = 6 if cell.kind == "train" else 2
    return float(mult) * n * tokens
