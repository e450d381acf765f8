"""Dispatch for the SSD kernels: ``csrc/ssd.cu`` for CUDA tensors, the
plain version (``ref.ssd_ref``, ``ref.ssd_backward_ref``) for CPU tensors.

:func:`ssd` is differentiable: where grad mode is on and an input wants a
gradient it goes through :class:`_SSD`: its forward also keeps the state
at each 64-token tile's start, and its backward is the backward kernel
(``ssd_bwd``: dxdt, dlogd, dB, dC) on those states or, for CPU tensors,
autograd through the plain version.  Otherwise (serving) it is the
forward kernel alone, without the states."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mamba2_ssd.ref import (STATE_TILE, ssd_backward_ref,
                                                 ssd_ref)
from repro_torch.obs.trace import kernel_launch

KERNEL = "mamba2_ssd"
BACKWARD = f"{KERNEL}.backward"
# xdt, logd, B, C, y, hfin, chunk-start states (or NULL); BH, S, P, N,
# chunk, heads; stream
_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
# xdt, logd, B, C, dy, dh_final, chunk-start states, dxdt, dlogd, dB, dC,
# workspace; BH, S, P, N, heads; stream
_BWD_ARGS = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# BH, S, P, N, heads -> bytes of the backward's workspace (-1: the state
# is too wide for a block)
_BWD_WS_ARGS = [ctypes.c_int] * 5


def ssd(xdt, logd, Bv, Cv, *, chunk=128, heads=1):
    """Chunked SSD scan.  xdt (BH, S, P), logd (BH, S), Bv/Cv
    (BH // heads, S, N), all float32: B and C are shared by ``heads``
    consecutive rows of xdt (Mamba-2's ngroups = 1), so the caller need
    not copy them per head.  Returns y (BH, S, P) without the D skip, and
    the final state (BH, P, N).  On the card a chunk runs as chunks of at
    most 64 tokens (the same function; see ``csrc/ssd.cu``)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xdt, logd, Bv, Cv)):
        return _SSD.apply(xdt, logd, Bv, Cv, chunk, heads)
    return _forward(xdt, logd, Bv, Cv, chunk, heads)


def _forward(xdt, logd, Bv, Cv, chunk, heads, states=False):
    """(y, hfin), and with ``states`` the state at each STATE_TILE-token
    tile's start (BH, ceil(S / STATE_TILE), P, N) as a third output (the
    kernel then runs in tiles of STATE_TILE tokens)."""
    BH, S, P = xdt.shape
    N = Bv.shape[-1]
    chunk = min(STATE_TILE if states else chunk, S)
    kernel_launch(KERNEL, backend=xdt.device.type, heads=BH, seq=S)
    if xdt.device.type == "cpu":
        return ssd_ref(xdt, logd, Bv, Cv, heads=heads, states=states)
    if BH % heads:
        raise ValueError(f"ssd: {BH} rows are not groups of {heads} heads")
    dev = xdt.device
    f32 = torch.float32
    chk = _build.checked
    ins = [chk("xdt", xdt.contiguous(), f32, (BH, S, P), dev),
           chk("logd", logd.contiguous(), f32, (BH, S), dev),
           chk("Bv", Bv.contiguous(), f32, (BH // heads, S, N), dev),
           chk("Cv", Cv.contiguous(), f32, (BH // heads, S, N), dev)]
    y = torch.empty((BH, S, P), dtype=f32, device=dev)
    hfin = torch.empty((BH, P, N), dtype=f32, device=dev)
    hst = (torch.empty((BH, -(-S // STATE_TILE), P, N), dtype=f32,
                       device=dev) if states else None)
    f = _build.bind("ssd", "ssd_fwd", _ARGS)
    _build.launch(KERNEL, f, *[t.data_ptr() for t in ins], y.data_ptr(),
                  hfin.data_ptr(), None if hst is None else hst.data_ptr(),
                  BH, S, P, N, chunk, heads, _build.stream_ptr(dev))
    return (y, hfin, hst) if states else (y, hfin)


def ssd_backward(dy, dh_final, xdt, logd, Bv, Cv, *, heads=1, states=None):
    """The gradient of :func:`ssd` from ``dy`` (BH, S, P) and ``dh_final``
    (BH, P, N; None counts as zero): ``(dxdt, dlogd, dB, dC)``, dB and dC
    (BH // heads, S, N) summed over the ``heads`` rows that share them.
    CUDA tensors run the backward kernel on ``states``, the forward's
    state at each STATE_TILE-token tile's start (``_forward(...,
    states=True)``), or, when they are not given, on states from one
    forward launch made here; CPU tensors differentiate the plain
    version."""
    BH, S, P = xdt.shape
    N = Bv.shape[-1]
    kernel_launch(BACKWARD, backend=xdt.device.type, heads=BH, seq=S)
    if xdt.device.type == "cpu":
        return ssd_backward_ref(dy, dh_final, xdt, logd, Bv, Cv, heads=heads)
    if BH % heads:
        raise ValueError(f"ssd backward: {BH} rows are not groups of "
                         f"{heads} heads")
    dev = xdt.device
    f32 = torch.float32
    chk = _build.checked
    G = BH // heads
    ins = [chk("xdt", xdt.contiguous(), f32, (BH, S, P), dev),
           chk("logd", logd.contiguous(), f32, (BH, S), dev),
           chk("Bv", Bv.contiguous(), f32, (G, S, N), dev),
           chk("Cv", Cv.contiguous(), f32, (G, S, N), dev),
           chk("dy", dy.contiguous(), f32, (BH, S, P), dev)]
    dhf = None if dh_final is None else chk(
        "dh_final", dh_final.contiguous(), f32, (BH, P, N), dev)
    # each block's partials (when heads or state blocks share an output),
    # written before read
    nbytes = _build.bind("ssd", "ssd_bwd_workspace", _BWD_WS_ARGS,
                         ctypes.c_longlong)(BH, S, P, N, heads)
    if nbytes < 0:
        raise ValueError(f"ssd backward: a {P} x {N} state does not fit "
                         f"a block of the kernel")
    if states is None:
        states = _forward(*ins[:4], STATE_TILE, heads, states=True)[2]
    hst = chk("states", states, f32, (BH, -(-S // STATE_TILE), P, N), dev)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    dxdt = torch.empty((BH, S, P), dtype=f32, device=dev)
    dlogd = torch.empty((BH, S), dtype=f32, device=dev)
    dB, dC = torch.empty((2, G, S, N), dtype=f32, device=dev).unbind(0)
    f = _build.bind("ssd", "ssd_bwd", _BWD_ARGS)
    _build.launch(BACKWARD, f, *[t.data_ptr() for t in ins],
                  None if dhf is None else dhf.data_ptr(), hst.data_ptr(),
                  *[t.data_ptr() for t in (dxdt, dlogd, dB, dC)],
                  ws.data_ptr() if nbytes else None,
                  BH, S, P, N, heads, _build.stream_ptr(dev))
    return dxdt, dlogd, dB, dC


class _SSD(torch.autograd.Function):
    """ssd with the backward kernel as its gradient.  The contiguous
    copies the kernels take are made inside, so the caller's graph
    reaches xdt, logd, Bv and Cv as they are.  The forward's chunk-start
    states are saved with ``save_for_backward``, so that under
    ``torch.utils.checkpoint`` they are dropped and recomputed with the
    rest of the block."""

    @staticmethod
    def forward(ctx, xdt, logd, Bv, Cv, chunk, heads):
        y, hfin, hst = _forward(xdt, logd, Bv, Cv, chunk, heads, states=True)
        ctx.save_for_backward(xdt, logd, Bv, Cv, hst)
        ctx.heads = heads
        return y, hfin

    @staticmethod
    def backward(ctx, dy, dh_final):
        # autograd hands zeros for an output that no gradient reached
        xdt, logd, Bv, Cv, hst = ctx.saved_tensors
        dxdt, dlogd, dB, dC = ssd_backward(dy, dh_final, xdt, logd, Bv, Cv,
                                           heads=ctx.heads, states=hst)
        return dxdt, dlogd, dB, dC, None, None
