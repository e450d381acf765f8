"""The bf16 flash-attention backward's dQ turn table, by its plain version
(``kernels/flash_attention/ref.py::dq_turns``), against the brute-force
visibility of every (query, key) pair.

The backward kernel (``csrc/flash_attention.cu``) adds the dQ share of
each key tile into a float32 scratch tile per (request, query head,
query tile) in the order of this table: a key tile that some query of the
tile sees must be in it (or its share is lost), a tile marked "full" is
computed without the per-element mask (so every pair in it must be
visible), and the ranks must run 0 .. count - 1, the highest key tile
first (the order the kernel's blocks reach a query tile under a causal
mask).  Positions: causal, a window, -1 padded key slots, positions that
are not an arange, and query rows that see no key (their tiles get no
turn when no row of the tile sees a key).  The card runs the same
classification (``plan_row``); its gradients are held against autograd
on the card by ``chip_smoke.py``.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import dq_turns, visible

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
        / "flash_attention.cu")


def _cases():
    rng = np.random.default_rng(3)
    ar = lambda n, off=0: torch.arange(off, off + n, dtype=torch.int32)
    pad = torch.where(ar(300) % 7 == 3, -1, ar(300))
    scattered = torch.tensor(np.sort(rng.choice(2000, 260, replace=False)),
                             dtype=torch.int32)
    shuffled = torch.tensor(rng.permutation(300), dtype=torch.int32)
    return {
        "causal": (ar(300), ar(300), True, None),
        "causal-long": (ar(2048), ar(2048), True, None),
        "window": (ar(300), ar(300), True, 40),
        "bidirectional": (ar(150), ar(260), False, None),
        "padded-keys": (ar(300), pad, True, None),
        "padded-window": (ar(300), pad, True, 100),
        "scattered": (scattered, scattered, True, 64),
        "shuffled": (shuffled, ar(300), True, None),
        # queries 0-99 see no key: keys start at 100
        "no-key-rows": (ar(300), ar(200, 100), True, None),
        "none-at-all": (ar(70), ar(40, 200), True, None),
    }


CASES = _cases()


def _brute(q_pos, k_pos, causal, window, bq, bk):
    """(nq, nk) bool: some pair of the two tiles is visible."""
    mask = visible(q_pos, k_pos, causal=causal, window=window)
    nq, nk = -(-len(q_pos) // bq), -(-len(k_pos) // bk)
    out = torch.zeros((nq, nk), dtype=torch.bool)
    for i in range(nq):
        for j in range(nk):
            out[i, j] = bool(mask[i * bq:(i + 1) * bq,
                                  j * bk:(j + 1) * bk].any())
    return out, mask


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("name", list(CASES))
def test_turn_table_covers_every_visible_pair(name, D):
    """Every tile pair with a visible (query, key) pair is in the table;
    under a causal mask on contiguous positions it is exactly those."""
    q_pos, k_pos, causal, window = CASES[name]
    bq, bk = fa.bwd_tiles(D)
    vis, full, rank, count = dq_turns(q_pos, k_pos, causal=causal,
                                      window=window, block_q=bq, block_k=bk)
    want, _ = _brute(q_pos, k_pos, causal, window, bq, bk)
    assert vis.shape == want.shape
    assert not (want & ~vis).any(), "a visible pair's key tile has no turn"
    if name in ("causal", "causal-long", "window", "no-key-rows",
                "none-at-all"):
        assert torch.equal(vis, want)
    assert torch.equal(count, vis.int().sum(1))
    # a query tile no row of which sees a key takes no turn
    assert (count[~want.any(1)] == 0).all()


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("name", list(CASES))
def test_turn_table_full_tiles_need_no_mask(name, D):
    """A tile pair marked full has every pair visible: all its keys are
    real slots and every query of the tile sees each of them."""
    q_pos, k_pos, causal, window = CASES[name]
    bq, bk = fa.bwd_tiles(D)
    vis, full, _, _ = dq_turns(q_pos, k_pos, causal=causal, window=window,
                               block_q=bq, block_k=bk)
    _, mask = _brute(q_pos, k_pos, causal, window, bq, bk)
    assert not (full & ~vis).any()
    for i, j in full.nonzero().tolist():
        keys = k_pos[j * bk:(j + 1) * bk]
        assert len(keys) == bk and (keys >= 0).all()
        assert mask[i * bq:(i + 1) * bq, j * bk:(j + 1) * bk].all()


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("name", list(CASES))
def test_turn_table_ranks_run_from_the_highest_key_tile(name, D):
    """Each query tile's visible key tiles hold ranks 0 .. count - 1 in
    descending key-tile order; the rest hold -1."""
    q_pos, k_pos, causal, window = CASES[name]
    bq, bk = fa.bwd_tiles(D)
    vis, _, rank, count = dq_turns(q_pos, k_pos, causal=causal,
                                   window=window, block_q=bq, block_k=bk)
    for i in range(vis.shape[0]):
        tiles = vis[i].nonzero().flatten().tolist()
        assert rank[i, tiles].tolist() == list(range(len(tiles)))[::-1]
        assert int(count[i]) == len(tiles)
        assert (rank[i, ~vis[i]] == -1).all()


def test_turn_table_tiles_match_the_kernel_source():
    """The wrapper's tile sizes are the kernel's: BQ query rows a tile (128
    where both head dims are at most 64, else 64: at 128, 80 and MLA's
    (96, 64)), 64 keys a consumer warpgroup times NWG warpgroups a
    block."""
    src = CSRC.read_text()
    bq = re.search(r"static constexpr int BQ = DK <= 64 && DV <= 64 "
                   r"\? (\d+) : (\d+);", src)
    nwg = int(re.search(r"static constexpr int NWG = (\d+);", src).group(1))
    assert "BKT = 64 * NWG" in src
    for dk, dv in ((128, 128), (80, 80), (96, 64)):
        assert fa.bwd_tiles(dk, dv) == (int(bq.group(2)), 64 * nwg)
    assert fa.bwd_tiles(128) == (int(bq.group(2)), 64 * nwg)
    for D in (16, 32, 64):
        assert fa.bwd_tiles(D) == (int(bq.group(1)), 64 * nwg)
