"""Mamba2 SSD chunk scan: the wrapper of B5.

``ssd_chunk_scan`` is the port of the JAX package's Pallas kernel of the
same name (``kernels/ssd.py``): the chunked state-space-duality scan of one
Mamba2 layer's prefill, returning ``y`` and the final state. On a CPU tensor
it runs the plain version (``kernels.ref.ssd_chunk_ref``); on a CUDA tensor
it launches ``csrc/ssd_chunk_scan.cu`` or raises -- it never falls back.

Where the JAX wrapper (``ops.ssd``) pads the sequence to a multiple of the
chunk and transposes x, B and C to ``(B, heads, chunks, L, width)``, the
kernel reads the model's layout in place: x ``(B, S, nh, hd)`` and B, C
``(B, S, G, ds)`` through their strides (they are column slices of the conv
output), and it masks a ragged last chunk itself. ``ssd_chunk_scan.launches``
counts launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import DTYPE_CODES
from repro_torch.kernels.ref import ssd_chunk_ref

DS_MAX = 128  # the kernel stages B and C rows of at most this many state dims


@functools.cache
def _launcher():
    """The kernel's C entry point, built and loaded on first use."""
    lib = _build.load("ssd_chunk_scan")
    fn = lib.ssd_chunk_scan_launch
    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    fn.argtypes = [p] * 8 + [i] * 6 + [ll] * 9 + [i, p]
    fn.restype = i
    err = lib.ssd_chunk_scan_error_string
    err.argtypes, err.restype = [i], ctypes.c_char_p
    return fn, err


def _check(x, dt, A, Bm, Cm, h0):
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 4 or Bm.shape != Cm.shape:
        raise ValueError(f"want x (B,S,nh,hd), dt (B,S,nh), A (nh,), B/C (B,S,G,ds); got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    Bsz, S, nh, hd = x.shape
    G, ds = Bm.shape[2], Bm.shape[3]
    if dt.shape != (Bsz, S, nh) or A.shape[0] != nh or Bm.shape[:2] != (Bsz, S) or nh % G:
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B/C {tuple(Bm.shape)}")
    if h0 is not None and h0.shape != (Bsz, nh, hd, ds):
        raise ValueError(f"h0 {tuple(h0.shape)} is not (B, nh, hd, ds) = {(Bsz, nh, hd, ds)}")
    tensors = [x, dt, A, Bm, Cm] + ([] if h0 is None else [h0])
    if len({t.device for t in tensors}) != 1:
        raise TypeError(f"inputs on several devices: {[str(t.device) for t in tensors]}")
    if not x.is_cuda:
        return
    if x.dtype not in DTYPE_CODES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"kernel takes x, B, C of one dtype, float32 or bfloat16; got "
                        f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if any(t.dtype != torch.float32 for t in [dt, A] + ([] if h0 is None else [h0])):
        raise TypeError("kernel takes dt, A and h0 in float32")
    if ds > DS_MAX or S < 1:
        raise ValueError(f"kernel takes 1 <= S and ds <= {DS_MAX}, got S={S}, ds={ds}")
    if x.stride(3) != 1 or Bm.stride(3) != 1 or Bm.stride() != Cm.stride():
        raise ValueError(f"x, B and C need a contiguous last axis and B, C one set of strides; "
                         f"got {x.stride()}, {Bm.stride()}, {Cm.stride()}")
    if not A.is_contiguous() or (h0 is not None and not h0.is_contiguous()):
        raise ValueError("A and h0 must be contiguous")
    if x.dtype == torch.bfloat16 and (
            ds % 8 or hd % 8 or any(st % 8 for st in x.stride()[:3] + Bm.stride()[:3])
            or any(t.data_ptr() % 16 for t in (x, Bm, Cm))):
        raise ValueError("the bf16 kernel stages x, B and C by 16-byte copies: it needs hd, ds "
                         "and their strides multiples of 8 and 16-byte aligned bases; got "
                         f"hd={hd}, ds={ds}, strides {x.stride()}, {Bm.stride()}")


def ssd_chunk_scan(x, dt, A, Bm, Cm, h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,nh,hd); dt: (B,S,nh) fp32; A: (nh,) fp32; Bm/Cm: (B,S,G,ds);
    h0: (B,nh,hd,ds) fp32 or None (zeros). Returns y (B,S,nh,hd) in x's
    dtype and the final state hT (B,nh,hd,ds) fp32."""
    _check(x, dt, A, Bm, Cm, h0)
    if not x.is_cuda:
        return ssd_chunk_ref(x, dt, A, Bm, Cm, h0)
    Bsz, S, nh, hd = x.shape
    G, ds = Bm.shape[2], Bm.shape[3]
    y = torch.empty((Bsz, S, nh, hd), dtype=x.dtype, device=x.device)
    hT = torch.empty((Bsz, nh, hd, ds), dtype=torch.float32, device=x.device)
    fn, err_string = _launcher()
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
             None if h0 is None else h0.data_ptr(), y.data_ptr(), hT.data_ptr(),
             Bsz, S, nh, hd, G, ds, *x.stride()[:3], *Bm.stride()[:3], *dt.stride(),
             DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk_scan launch failed: {err_string(err).decode()}")
    ssd_chunk_scan.launches += 1
    return y, hT


ssd_chunk_scan.launches = 0
