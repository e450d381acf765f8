"""Plain PyTorch version of the index merge, port of
``repro.kernels.index_merge.ref.segment_merge_ref`` over a batch of P
segments (the reference's ``vmap`` written out as a batch dimension).

It runs for CPU tensors only (``ops.index_merge`` dispatches); on the card
the CUDA kernel ``csrc/index_merge.cu`` computes the same function and
``chip_smoke.py`` holds the two equal.
"""
from __future__ import annotations

import torch

from repro_torch.storage.index import SENTINEL


def index_merge_plain(key, prow, tid, del_key, ik, ip, it):
    """key/prow/tid: (P, cap) sorted canonical segments; del_key: (P, Kd ≥ 1)
    with SENTINEL = masked out; ik/ip/it: (P, Ki ≥ 1) inserts, each row
    sorted ascending by key (stable), SENTINEL = masked out.  Returns
    (key', prow', tid' (P, cap), overflow (P,) int32)."""
    P, cap = key.shape
    Ki = ik.shape[1]
    i32 = torch.int32
    # -- deletes: searchsorted position, exact-match test -> holes
    pos = torch.searchsorted(key, del_key).clamp(0, cap - 1)
    hit = (key.gather(1, pos) == del_key) & (del_key != SENTINEL)
    tgt = torch.where(hit, pos, cap)
    tgt_s = torch.sort(tgt, dim=1).values
    # dedup: two del ops hitting the same slot make ONE hole
    uniq = torch.cat([tgt_s[:, :1] < cap,
                      (tgt_s[:, 1:] != tgt_s[:, :-1]) & (tgt_s[:, 1:] < cap)],
                     dim=1)
    n_dead = uniq.sum(1)
    holes_before = torch.cumsum(uniq, 1) - uniq.long()
    r_hole = tgt_s - holes_before

    # -- inserts: sorted-run merge in gather form
    ilive = ik != SENTINEL
    n_ilive = ilive.sum(1)
    sent = torch.full((P, 1), int(SENTINEL), dtype=key.dtype,
                      device=key.device)
    n_live = torch.searchsorted(key, sent)[:, 0] - n_dead
    ss = torch.searchsorted(key, ik, right=True)
    dead_below = (uniq[:, None, :] & (tgt_s[:, None, :] < ss[:, :, None])
                  ).sum(2)
    pos_i = torch.arange(Ki, device=key.device) + ss - dead_below
    inc_at = torch.zeros((P, cap + 1), dtype=torch.int64, device=key.device)
    inc_at.scatter_add_(1, torch.where(ilive, pos_i.clamp(max=cap), cap),
                        torch.ones_like(pos_i))
    d_at = torch.zeros((P, cap + 1), dtype=torch.int64, device=key.device)
    d_at.scatter_add_(1, torch.where(uniq, r_hole.clamp(0, cap - 1), cap),
                      torch.ones_like(r_hole))
    inc_at, d_at = inc_at[:, :cap], d_at[:, :cap]
    J = torch.cumsum(inc_at, 1)
    D = torch.cumsum(d_at, 1)
    o = torch.arange(cap, device=key.device)
    is_inc = inc_at > 0
    j_excl = J - inc_at
    r = o - j_excl
    i_src = (r + D.gather(1, r.clamp(0, cap - 1))).clamp(0, cap - 1)
    jidx = j_excl.clamp(0, max(Ki - 1, 0))
    n_merged = n_live + n_ilive
    valid = o < n_merged[:, None]
    k2 = torch.where(valid, torch.where(is_inc, ik.gather(1, jidx),
                                        key.gather(1, i_src)), SENTINEL)
    live = k2 != SENTINEL
    p2 = torch.where(live, torch.where(is_inc, ip.gather(1, jidx),
                                       prow.gather(1, i_src)), 0)
    t2 = torch.where(live, torch.where(is_inc, it.gather(1, jidx),
                                       tid.gather(1, i_src)), 0)
    overflow = (n_merged - cap).clamp(min=0).to(i32)
    return k2.to(key.dtype), p2.to(prow.dtype), t2.to(tid.dtype), overflow
