"""Public wrappers (prefill ``mha`` and slot-cache ``decode``) over the
flash-attention kernel: ``csrc/flash_attention.cu`` for CUDA tensors, the
plain version (``ref.attention_ref``) for CPU tensors.

Layout (B, S, H, D) at the wrappers, as in the JAX package; the kernel
reads that layout through its strides, so nothing is transposed on the
card.  ``block_q``/``block_k`` are accepted for the JAX signatures; the
kernel's tiles are its own (64 query rows by 64 keys).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.obs.trace import kernel_launch

KERNEL = "flash_attention"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
         + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p])


def attention(q, k, v, q_pos, k_pos, *, causal=True, window=None,
              scale=None):
    """q: (B, Sq, H, D); k, v: (B, Sk, Hkv, D) with H % Hkv == 0 (query
    head h reads kv head h // (H // Hkv)); q_pos (Sq,), k_pos (Sk,) int32
    (-1 = empty slot).  Returns (B, Sq, H, D) in q's dtype.  Sq == 1 runs
    the decode configuration of the kernel, any other Sq the prefill one."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"attention: {H} query heads over {Hkv} kv heads")
    groups = H // Hkv
    scale = float(scale if scale is not None else D ** -0.5)
    name = f"{KERNEL}.{'decode' if Sq == 1 else 'prefill'}"
    kernel_launch(name, backend=q.device.type, q=Sq, k=Sk, heads=B * H)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, q_pos, k_pos, causal=causal,
                             window=window, scale=scale)
    if q.dtype not in DTYPES:
        raise ValueError(f"attention: dtype {q.dtype}, the kernel takes "
                         f"float32 or bfloat16")
    if D not in HEAD_DIMS:
        raise ValueError(f"attention: head dim {D}, the kernel takes "
                         f"{HEAD_DIMS}")
    dev = q.device
    chk = _build.checked
    qs = chk("q", _build.aligned16(q), q.dtype, (B, Sq, H, D), dev)
    ks = chk("k", _build.aligned16(k), q.dtype, (B, Sk, Hkv, D), dev)
    vs = chk("v", _build.aligned16(v), q.dtype, (B, Sk, Hkv, D), dev)
    qp = chk("q_pos", q_pos.to(torch.int32).contiguous(), torch.int32,
             (Sq,), dev)
    kp = chk("k_pos", k_pos.to(torch.int32).contiguous(), torch.int32,
             (Sk,), dev)
    o = torch.empty_like(qs)
    strides = [s for t in (qs, ks, vs, o) for s in
               (t.stride(0), t.stride(2), t.stride(1))]
    f = _build.bind("flash_attention", "flash_attention_fwd", _ARGS)
    _build.launch(name, f, qs.data_ptr(), ks.data_ptr(), vs.data_ptr(),
                  o.data_ptr(), qp.data_ptr(), kp.data_ptr(), B, H, groups,
                  Sq, Sk, D, *strides, scale, int(causal),
                  0 if window is None else int(window), DTYPES[q.dtype],
                  _build.stream_ptr(dev))
    return o


def mha(q, k, v, *, causal=True, window=None, block_q=256, block_k=256):
    """q: (B, Sq, H, D); k, v: (B, Sk, Hkv, D) -> (B, Sq, H, D)."""
    dev = q.device
    return attention(q, k, v, torch.arange(q.shape[1], dtype=torch.int32,
                                           device=dev),
                     torch.arange(k.shape[1], dtype=torch.int32, device=dev),
                     causal=causal, window=window)


def decode(q, k_cache, v_cache, slot_pos, pos, *, window=None, block_k=256):
    """q: (B, 1, H, D); caches: (B, S_alloc, Hkv, D); slot_pos: (S_alloc,)
    absolute positions per slot (-1 empty); pos: the current position."""
    q_pos = torch.full((1,), int(pos), dtype=torch.int32, device=q.device)
    return attention(q, k_cache, v_cache, q_pos, slot_pos, causal=True,
                     window=window)
