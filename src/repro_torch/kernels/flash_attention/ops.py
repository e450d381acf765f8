"""Public wrappers (prefill ``mha`` and slot-cache ``decode``) over the
flash-attention kernel: ``csrc/flash_attention.cu`` for CUDA tensors, the
plain version (``ref.attention_ref``) for CPU tensors.

Layout (B, S, H, D) at the wrappers, as in the JAX package, with v's head
dim (and the output's) that of ``v``: MLA's expanded form reads q and k
of 96 (64 + 32 rotary) and v of 64.  The kernel
reads that layout through its strides, so nothing is transposed on the
card.  K and V stay unexpanded: query head h reads kv head ``kv_head[h]``
through a table on the card (built from ``H // Hkv`` when no map is
given), which also lists the query heads of each kv head for decode.
``block_q``/``block_k`` are accepted for the JAX signatures; the kernel's
tiles are its own (64 query rows by 64 keys).

``mha`` is differentiable: where a gradient is wanted it runs the forward
kernel with each row's log-sum-exp as a second output and its backward is
the backward kernel (``flash_attention_bwd``: dQ, dK, dV), or, for CPU
tensors, autograd through the plain version.  Decode needs no gradient.

Decode splits each (request, kv head)'s slots over several blocks, which
combine through a scratch buffer and a counter per (request, kv head) kept
here per device; the kernel leaves the counters at zero, so no call
clears them.  Calls on one device must therefore run on one stream.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.obs.trace import kernel_launch

KERNEL = "flash_attention"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 128)        # q, k and v of one head dim
# every (q/k, v) head dim pair the kernel has an instance of
# (csrc/flash_attention.cu FA_HEAD_DIMS): the square ones and MLA's
HEAD_DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((96, 64),)
# the decode configuration's: a K/V row spans a power of two of lanes
DECODE_HEAD_DIMS = (16, 32, 64, 128)
MAX_HEADS = 256                  # csrc/flash_attention.cu MAX_HEADS
MAX_SPLITS = 32                  # csrc/flash_attention.cu MAX_SPLITS
# q, k, v, o, q_pos, k_pos, kv_head, ws, counters, lse; B, H, Hkv, Sq, Sk,
# DK, DV, splits; 12 strides; scale; causal, window, dtype; stream
_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
         + [ctypes.c_longlong] * 12
         + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p])
# q, k, v, o, dO, lse, q_pos, k_pos, kv_head, dq, dk, dv, workspace; B, H,
# Hkv, Sq, Sk, DK, DV; the 24 strides (a host array); scale; causal,
# window, dtype; stream
_BWD_ARGS = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 7
             + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
# B, H, Sq, Sk, DK, DV, dtype -> bytes of the backward's workspace
_BWD_WS_ARGS = [ctypes.c_int] * 7
BACKWARD = f"{KERNEL}.backward"

_TABLES: dict = {}   # (kv_head, Hkv, device) -> int32 table on the card
_SCRATCH: dict = {}  # device -> (ws float32, counters int32)
_SMS: dict = {}      # device -> streaming multiprocessors


def bwd_tiles(DK: int, DV: int | None = None) -> tuple:
    """The bf16 backward's tiles at head dims (DK, DV) (DV = DK when not
    given; ``csrc/flash_attention.cu`` ``BW<DK, DV>::BQ`` and
    ``BW<DK, DV>::BKT``): query rows a tile, keys a block of the fused
    kernel.  Its dQ turn table is ``ref.dq_turns`` over these."""
    DV = DK if DV is None else DV
    return (128 if DK <= 64 and DV <= 64 else 64), 128


def head_map(H: int, Hkv: int, kv_head=None) -> tuple:
    """The query head -> kv head map as a tuple of H ints in [0, Hkv)."""
    if kv_head is None:
        if H % Hkv:
            raise ValueError(f"attention: {H} query heads over {Hkv} kv "
                             f"heads need an explicit kv_head map")
        return tuple(h // (H // Hkv) for h in range(H))
    kv_head = tuple(int(x) for x in kv_head)
    if len(kv_head) != H or not all(0 <= x < Hkv for x in kv_head):
        raise ValueError(f"attention: kv_head {kv_head} is not a map of "
                         f"{H} query heads onto {Hkv} kv heads")
    return kv_head


def head_table(kv_head: tuple, Hkv: int) -> list:
    """The kernel's head table: the map itself, the query heads ordered by
    kv head, and the Hkv + 1 offsets of each kv head's run in that order."""
    order = sorted(range(len(kv_head)), key=lambda h: (kv_head[h], h))
    offsets = [sum(1 for x in kv_head if x < g) for g in range(Hkv + 1)]
    return list(kv_head) + order + offsets


def _table(kv_head: tuple, Hkv: int, dev):
    t = _TABLES.get((kv_head, Hkv, dev))
    if t is None:
        t = _TABLES[(kv_head, Hkv, dev)] = torch.tensor(
            head_table(kv_head, Hkv), dtype=torch.int32, device=dev)
    return t


def decode_splits(B: int, Hkv: int, Sk: int, dev) -> int:
    """Blocks per (request, kv head) in decode: as many as fill the card
    with two blocks an SM in one wave (the kernel's registers allow two),
    each with at least 64 slots, at most MAX_SPLITS."""
    sms = _SMS.get(dev)
    if sms is None:
        sms = _SMS[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return max(1, min(2 * sms // (B * Hkv), Sk // 64, MAX_SPLITS))


def _scratch(dev, n_ws: int, n_cnt: int):
    """The decode scratch of ``dev``, grown to the sizes asked for (new
    counters start at zero; the kernel leaves them there)."""
    ws, cnt = _SCRATCH.get(dev, (None, None))
    if ws is None or ws.numel() < n_ws:
        ws = torch.empty(n_ws, dtype=torch.float32, device=dev)
    if cnt is None or cnt.numel() < n_cnt:
        cnt = torch.zeros(n_cnt, dtype=torch.int32, device=dev)
    _SCRATCH[dev] = (ws, cnt)
    return ws, cnt


def attention(q, k, v, q_pos, k_pos, *, causal=True, window=None,
              scale=None, kv_head=None):
    """q: (B, Sq, H, DK); k: (B, Sk, Hkv, DK); v: (B, Sk, Hkv, DV); q_pos
    (Sq,), k_pos (Sk,) int32 (-1 = empty slot).  Query head h reads kv
    head ``kv_head[h]`` (H ints in [0, Hkv)); without a map H % Hkv == 0
    and it reads h // (H // Hkv).  ``scale`` defaults to DK ** -0.5.
    Returns (B, Sq, H, DV) in q's dtype.  Sq == 1 runs the decode
    configuration of the kernel, any other Sq the prefill one."""
    return _forward(q, k, v, q_pos, k_pos, causal, window, scale, kv_head,
                    False)[0]


def _check(q, Sq, DK, DV, H):
    if q.dtype not in DTYPES:
        raise ValueError(f"attention: dtype {q.dtype}, the kernel takes "
                         f"float32 or bfloat16")
    if (DK, DV) not in HEAD_DIM_PAIRS:
        raise ValueError(f"attention: head dims (q/k {DK}, v {DV}), the "
                         f"kernel takes {HEAD_DIM_PAIRS}")
    if Sq == 1 and (DK != DV or DK not in DECODE_HEAD_DIMS):
        raise ValueError(
            f"attention: head dims (q/k {DK}, v {DV}) in the decode "
            f"configuration (Sq == 1), which takes one head dim in "
            f"{DECODE_HEAD_DIMS}: MLA decodes in its absorbed form, with no "
            f"attention kernel, and HuBERT (80) is an encoder")
    if H > MAX_HEADS:
        raise ValueError(f"attention: {H} heads, the kernel takes at most "
                         f"{MAX_HEADS}")


def _forward(q, k, v, q_pos, k_pos, causal, window, scale, kv_head,
             want_lse):
    """:func:`attention`, and with ``want_lse`` (prefill only) also each
    row's log-sum-exp of its scaled scores, (B, H, Sq) float32 (None on the
    CPU, whose backward differentiates the plain version)."""
    B, Sq, H, D = q.shape
    Sk, Hkv, DV = k.shape[1], k.shape[2], v.shape[-1]
    kv_head = head_map(H, Hkv, kv_head)
    scale = float(scale if scale is not None else D ** -0.5)
    name = f"{KERNEL}.{'decode' if Sq == 1 else 'prefill'}"
    kernel_launch(name, backend=q.device.type, q=Sq, k=Sk, heads=B * H)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, q_pos, k_pos, causal=causal,
                             window=window, scale=scale,
                             kv_head=kv_head), None
    _check(q, Sq, D, DV, H)
    if want_lse and Sq == 1:
        raise ValueError("attention: no gradient for the decode "
                         "configuration (Sq == 1)")
    dev = q.device
    chk = _build.checked
    qs = chk("q", _build.aligned16(q), q.dtype, (B, Sq, H, D), dev)
    ks = chk("k", _build.aligned16(k), q.dtype, (B, Sk, Hkv, D), dev)
    vs = chk("v", _build.aligned16(v), q.dtype, (B, Sk, Hkv, DV), dev)
    qp = chk("q_pos", q_pos.to(torch.int32).contiguous(), torch.int32,
             (Sq,), dev)
    kp = chk("k_pos", _build.aligned16(k_pos.to(torch.int32)), torch.int32,
             (Sk,), dev)
    o = qs.new_empty((B, Sq, H, DV))
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
           if want_lse else None)
    splits, ws_ptr, cnt_ptr = 0, 0, 0
    if Sq == 1:
        splits = decode_splits(B, Hkv, Sk, dev)
        ws, cnt = _scratch(dev, B * H * splits * (DV + 2), B * Hkv)
        ws_ptr, cnt_ptr = ws.data_ptr(), cnt.data_ptr()
    strides = [s for t in (qs, ks, vs, o) for s in
               (t.stride(0), t.stride(2), t.stride(1))]
    f = _build.bind("flash_attention", "flash_attention_fwd", _ARGS)
    _build.launch(name, f, qs.data_ptr(), ks.data_ptr(), vs.data_ptr(),
                  o.data_ptr(), qp.data_ptr(), kp.data_ptr(),
                  _table(kv_head, Hkv, dev).data_ptr(), ws_ptr, cnt_ptr,
                  None if lse is None else lse.data_ptr(), B, H, Hkv, Sq, Sk,
                  D, DV, splits, *strides, scale, int(causal),
                  0 if window is None else int(window), DTYPES[q.dtype],
                  _build.stream_ptr(dev))
    return o, lse


def attention_backward(do, q, k, v, o, lse, q_pos, k_pos, *, causal=True,
                       window=None, scale=None, kv_head=None):
    """The gradient of prefill :func:`attention`: (dq, dk, dv), shaped and
    typed as q, k, v (v's head dim may differ from q's and k's, as
    :func:`attention` allows), from ``do`` (the gradient of ``o``), the
    forward's
    output ``o`` and its ``lse`` ((B, H, Sq) float32).  CUDA tensors run
    the backward kernel; CPU tensors differentiate the plain version
    (``o`` and ``lse`` unused).  A row that sees no key gets the forward's
    mean of v: its gradient reaches every v row (dO / Sk) and no q or k."""
    B, Sq, H, D = q.shape
    Sk, Hkv, DV = k.shape[1], k.shape[2], v.shape[-1]
    kv_head = head_map(H, Hkv, kv_head)
    scale = float(scale if scale is not None else D ** -0.5)
    kernel_launch(BACKWARD, backend=q.device.type, q=Sq, k=Sk, heads=B * H)
    if q.device.type == "cpu":
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = attention_ref(*leaves, q_pos, k_pos, causal=causal,
                                window=window, scale=scale, kv_head=kv_head)
            return torch.autograd.grad(out, leaves, do)
    if Sq == 1:
        raise ValueError("attention: no gradient for the decode "
                         "configuration (Sq == 1)")
    _check(q, Sq, D, DV, H)
    dev = q.device
    chk = _build.checked
    qs = chk("q", _build.aligned16(q), q.dtype, (B, Sq, H, D), dev)
    ks = chk("k", _build.aligned16(k), q.dtype, (B, Sk, Hkv, D), dev)
    vs = chk("v", _build.aligned16(v), q.dtype, (B, Sk, Hkv, DV), dev)
    os_ = chk("o", _build.aligned16(o), q.dtype, (B, Sq, H, DV), dev)
    dos = chk("do", _build.aligned16(do), q.dtype, (B, Sq, H, DV), dev)
    ls = chk("lse", lse.contiguous(), torch.float32, (B, H, Sq), dev)
    qp = chk("q_pos", q_pos.to(torch.int32).contiguous(), torch.int32,
             (Sq,), dev)
    kp = chk("k_pos", _build.aligned16(k_pos.to(torch.int32)), torch.int32,
             (Sk,), dev)
    dq, dk, dv = (torch.empty_like(t) for t in (qs, ks, vs))
    # D_i, the rows' table, the tile plan, the dQ turns and the float32 dQ
    # scratch (bf16: 4 B * H * Sq * D and more), written before read
    nbytes = _build.bind("flash_attention", "flash_attention_bwd_workspace",
                         _BWD_WS_ARGS, ctypes.c_longlong)(
        B, H, Sq, Sk, D, DV, DTYPES[q.dtype])
    ws = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    strides = (ctypes.c_longlong * 24)(*[
        s for t in (qs, ks, vs, os_, dos, dq, dk, dv)
        for s in (t.stride(0), t.stride(2), t.stride(1))])
    f = _build.bind("flash_attention", "flash_attention_bwd", _BWD_ARGS)
    _build.launch(BACKWARD, f, qs.data_ptr(), ks.data_ptr(), vs.data_ptr(),
                  os_.data_ptr(), dos.data_ptr(), ls.data_ptr(),
                  qp.data_ptr(), kp.data_ptr(),
                  _table(kv_head, Hkv, dev).data_ptr(), dq.data_ptr(),
                  dk.data_ptr(), dv.data_ptr(), ws.data_ptr(), B, H, Hkv, Sq,
                  Sk, D, DV, strides, scale, int(causal),
                  0 if window is None else int(window), DTYPES[q.dtype],
                  _build.stream_ptr(dev))
    return dq, dk, dv


class _MHA(torch.autograd.Function):
    """Prefill attention with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, causal, window, scale, kv_head):
        o, lse = _forward(q, k, v, q_pos, k_pos, causal, window, scale,
                          kv_head, True)
        ctx.save_for_backward(q, k, v, o, lse, q_pos, k_pos)
        ctx.mask = (causal, window, scale, kv_head)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, q_pos, k_pos = ctx.saved_tensors
        causal, window, scale, kv_head = ctx.mask
        dq, dk, dv = attention_backward(do, q, k, v, o, lse, q_pos, k_pos,
                                        causal=causal, window=window,
                                        scale=scale, kv_head=kv_head)
        return dq, dk, dv, None, None, None, None, None, None


def mha(q, k, v, *, causal=True, window=None, block_q=256, block_k=256,
        scale=None, kv_head=None):
    """q: (B, Sq, H, DK); k: (B, Sk, Hkv, DK); v: (B, Sk, Hkv, DV) ->
    (B, Sq, H, DV); ``scale`` defaults to DK ** -0.5.  Differentiable:
    where grad mode is on and q, k or v wants a gradient it goes through
    :class:`_MHA`; otherwise (serving) it is :func:`attention` as it
    was."""
    dev = q.device
    q_pos = torch.arange(q.shape[1], dtype=torch.int32, device=dev)
    k_pos = torch.arange(k.shape[1], dtype=torch.int32, device=dev)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _MHA.apply(q, k, v, q_pos, k_pos, causal, window, scale,
                          kv_head)
    return attention(q, k, v, q_pos, k_pos, causal=causal, window=window,
                     scale=scale, kv_head=kv_head)


def decode(q, k_cache, v_cache, slot_pos, pos, *, window=None, block_k=256,
           kv_head=None):
    """q: (B, 1, H, D); caches: (B, S_alloc, Hkv, D); slot_pos: (S_alloc,)
    absolute positions per slot (-1 empty); pos: the current position."""
    q_pos = torch.full((1,), int(pos), dtype=torch.int32, device=q.device)
    return attention(q, k_cache, v_cache, q_pos, slot_pos, causal=True,
                     window=window, kv_head=kv_head)
