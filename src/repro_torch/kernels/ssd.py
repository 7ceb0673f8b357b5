"""Mamba2 SSD chunk scan: the wrapper of B5.

``ssd_chunk_scan`` is the port of the JAX package's Pallas kernel of the
same name (``kernels/ssd.py``): the chunked state-space-duality scan of one
Mamba2 layer's prefill, returning ``y`` and the final state. On a CPU tensor
it runs the plain version (``kernels.ref.ssd_chunk_ref``); on a CUDA tensor
it launches ``src/repro_torch/kernels/csrc/ssd_chunk_scan.cu`` or raises --
it never falls back.

Where the JAX wrapper (``ops.ssd``) pads the sequence to a multiple of the
chunk and transposes x, B and C to ``(B, heads, chunks, L, width)``, the
kernel reads the model's layout in place: x ``(B, S, nh, hd)`` and B, C
``(B, S, G, ds)`` through their strides (they are column slices of the conv
output), and it masks a ragged last chunk itself.

The kernel runs the chunks in parallel: work items (chunk, head, a slice of
hd) taken from an atomic ticket in chunk-major order, each
waiting for its predecessor chunk's end state only after the work that does
not need it. The end states pass through a ring in one scratch a device,
kept from call to call (``_scratch``): its size comes from the kernel
source's ``ssd_chunk_scan_scratch_layout`` (the Python copy of that schedule
is ``ref.ssd_chunk_schedule``), it is zeroed when first made, and each call
gets the next epoch number, with which the kernel tags its flags, so no call
resets it. Calls that share a device's scratch must run one at a time (one
stream). One wrapper call is one C call and one launch;
``ssd_chunk_scan.launches`` counts them. hT is always a fresh tensor: it
never aliases h0.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import DTYPE_CODES
from repro_torch.kernels.ref import ssd_chunk_ref

DS_MAX = 128  # the kernel stages B and C rows of at most this many state dims


@functools.cache
def _launcher():
    """The kernel's C entry points, built and loaded on first use."""
    lib = _build.load("ssd_chunk_scan")
    fn = lib.ssd_chunk_scan_launch
    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    fn.argtypes = [p] * 8 + [i] * 6 + [ll] * 9 + [p, ll, ctypes.c_uint, i, i, p]
    fn.restype = i
    layout = lib.ssd_chunk_scan_scratch_layout
    layout.argtypes = [i] * 8 + [ctypes.POINTER(ll)]
    layout.restype = i
    err = lib.ssd_chunk_scan_error_string
    err.argtypes, err.restype = [i], ctypes.c_char_p
    return fn, layout, err


SCHEDULE_KEYS = ("grid", "hs", "ipc", "ring", "nc", "nbytes")


@functools.lru_cache(maxsize=None)
def schedule(batch: int, seq: int, nh: int, hd: int, groups: int, ds: int, dtype_code: int,
             sms: int) -> dict:
    """The kernel's schedule of one call (``ssd_chunk_scan_scratch_layout``
    in the kernel source): its grid, hd columns an item, items a chunk, ring
    slots, chunks and scratch bytes."""
    _, layout, err_string = _launcher()
    out = (ctypes.c_longlong * len(SCHEDULE_KEYS))()
    err = layout(batch, seq, nh, hd, groups, ds, dtype_code, sms, out)
    if err != 0:
        raise ValueError(f"ssd_chunk_scan takes no such call: {err_string(err).decode()}")
    return dict(zip(SCHEDULE_KEYS, out))


class _Scratch:
    """One device's scratch: zeroed when made (or grown), then tagged anew by
    each call's epoch."""

    def __init__(self):
        self.tensor: Optional[torch.Tensor] = None
        self.epoch = 0

    def take(self, device, nbytes: int):
        if self.tensor is None or self.tensor.numel() < nbytes:
            self.tensor = torch.zeros(nbytes, dtype=torch.uint8, device=device)
        self.epoch += 1
        if self.epoch >= 2**32:  # the flags hold 32 bits of it: start again from zeros
            self.tensor.zero_()
            self.epoch = 1
        return self.tensor, self.epoch


_SCRATCH: Dict[int, _Scratch] = {}


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    dev = x.device
    code = DTYPE_CODES[x.dtype]
    sms = _sm_count(dev.index)
    nbytes = schedule(Bsz, S, nh, hd, G, ds, code, sms)["nbytes"]
    scratch, epoch = _SCRATCH.setdefault(dev.index, _Scratch()).take(dev, nbytes)
    y = torch.empty((Bsz, S, nh, hd), dtype=x.dtype, device=dev)
    hT = torch.empty((Bsz, nh, hd, ds), dtype=torch.float32, device=dev)
    fn, _, err_string = _launcher()
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
             None if h0 is None else h0.data_ptr(), y.data_ptr(), hT.data_ptr(),
             Bsz, S, nh, hd, G, ds, *x.stride()[:3], *Bm.stride()[:3], *dt.stride(),
             scratch.data_ptr(), scratch.numel(), epoch, sms, code,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk_scan launch failed: {err_string(err).decode()}")
    ssd_chunk_scan.launches += 1
    return y, hT


ssd_chunk_scan.launches = 0
