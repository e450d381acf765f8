"""Plain PyTorch version of the flash-attention kernel
(``csrc/flash_attention.cu``): masked attention with explicit (q_pos, k_pos)
positions, mirroring ``repro/kernels/flash_attention/ref.py``.

Covers causal prefill, bidirectional encoding, sliding windows and
slot-cache decode (k_pos = slot positions, -1 = empty).  Query head ``h``
reads kv head ``kv_head[h]`` (``h // groups`` by default); the kv heads are
expanded with :func:`expand_kv`, as the JAX model does, and only here: the
kernel reads them unexpanded.

A query row that sees no key gets a uniform softmax, the mean of every
value row, as the JAX oracle's softmax over a row of -1e30 and the Pallas
kernel (p = 1 for each key, l = Sk) give.  On the serve path no row is
fully masked, since every query sees its own position.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def visible(q_pos, k_pos, *, causal=True, window=None):
    """(Sq, Sk) bool: which keys each query sees."""
    mask = (k_pos[None, :] >= 0).expand(q_pos.shape[0], -1)
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    return mask


def expand_kv(k, groups: int, index_map=None):
    """(B, S, Hkv, Dh) -> (B, S, H, Dh).  With padded heads the q->kv
    assignment is an explicit gather (the grouping is irregular)."""
    if index_map is not None:
        return k[:, :, torch.as_tensor(index_map, device=k.device), :]
    if groups == 1:
        return k
    return k.repeat_interleave(groups, dim=2)


def flash_attention_ref(q, k, v, q_pos, k_pos, *, groups=1, causal=True,
                        window=None, scale=None):
    """q: (BH, Sq, DK); k: (BH // groups, Sk, DK); v: (BH // groups, Sk,
    DV); q_pos (Sq,), k_pos (Sk,) int32 -> (BH, Sq, DV).  Scores and
    softmax in float32; the probabilities are rounded to v's dtype before
    the product with v, as the JAX oracle does."""
    D = q.shape[-1]
    scale = scale if scale is not None else D ** -0.5
    if groups > 1:
        k = k.repeat_interleave(groups, dim=0)
        v = v.repeat_interleave(groups, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    mask = visible(q_pos, k_pos, causal=causal, window=window)
    s = s.masked_fill(~mask[None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(),
                        v.float()).to(v.dtype)


def attention_ref(q, k, v, q_pos, k_pos, *, causal=True, window=None,
                  scale=None, kv_head=None):
    """:func:`flash_attention_ref` in the wrappers' (B, S, H, D) layout:
    q (B, Sq, H, DK), k (B, Sk, Hkv, DK), v (B, Sk, Hkv, DV) -> (B, Sq, H,
    DV).  ``kv_head``: query head -> kv head (``h // (H // Hkv)`` when
    None)."""
    B, Sq, H, D = q.shape
    Sk, Hkv, DV = k.shape[1], k.shape[2], v.shape[-1]
    if kv_head is not None:
        k, v = expand_kv(k, 1, kv_head), expand_kv(v, 1, kv_head)
        Hkv = H
    out = flash_attention_ref(
        q.transpose(1, 2).reshape(B * H, Sq, D),
        k.transpose(1, 2).reshape(B * Hkv, Sk, D),
        v.transpose(1, 2).reshape(B * Hkv, Sk, DV),
        q_pos, k_pos, groups=H // Hkv, causal=causal, window=window,
        scale=scale)
    return out.reshape(B, H, Sq, DV).transpose(1, 2)


def dq_turns(q_pos, k_pos, *, causal=True, window=None, block_q=64,
             block_k=128):
    """The plain version of the bf16 backward's tile plan
    (``csrc/flash_attention.cu``, ``plan_row``), which orders the adds into
    each tile of dQ.  Query tile i holds rows [block_q i, block_q (i + 1))
    of ``q_pos``, key tile j keys [block_k j, block_k (j + 1)) of
    ``k_pos``.  Returns (vis, full, rank, count): vis[i, j] when, by the
    min and max of the tiles' positions (a key's position < 0 is an empty
    slot), a query of tile i may see a key of tile j; full[i, j] when
    every query of tile i sees every key of tile j (no empty slot, no
    ragged end); rank[i, j] the number of visible key tiles above j (-1
    where j is not visible), the order in which the key tiles add into
    query tile i; count[i] the number of visible key tiles."""
    q = [int(x) for x in q_pos.tolist()]
    k = [int(x) for x in k_pos.tolist()]
    nq = (len(q) + block_q - 1) // block_q
    nk = (len(k) + block_k - 1) // block_k
    vis = torch.zeros((nq, nk), dtype=torch.bool)
    full = torch.zeros((nq, nk), dtype=torch.bool)
    for i in range(nq):
        rows = q[i * block_q:(i + 1) * block_q]
        qlo, qhi = min(rows), max(rows)
        for j in range(nk):
            keys = k[j * block_k:(j + 1) * block_k]
            valid = [p for p in keys if p >= 0]
            empty = len(valid) < block_k
            if not valid:
                continue
            lo, hi = min(valid), max(valid)
            vis[i, j] = ((not causal or lo <= qhi)
                         and (window is None or hi > qlo - window))
            full[i, j] = (not empty and (not causal or hi <= qlo)
                          and (window is None or lo > qhi - window))
    above = vis.flip(1).int().cumsum(1).flip(1) - vis.int()
    rank = torch.where(vis, above, torch.full_like(above, -1))
    return vis, full & vis, rank, vis.int().sum(1)
