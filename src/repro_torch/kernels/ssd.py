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
not need it. The end states pass through a ring in a scratch kept from
call to call, one for each (device, stream) (``_SCRATCH``), so calls on two
streams never share one and calls on one stream run one at a time. Its
size comes from the kernel source's ``ssd_chunk_scan_scratch_layout`` (the
Python copy of that schedule is ``ref.ssd_chunk_schedule``); it is made
zero but for its epoch word (``EPOCH_WORD``), which is 1. From then on the
kernel owns it: each launch reads the epoch from that word, tags its flags
with it, and its last CTA moves it on, so no call resets the scratch and a
launch replayed from a CUDA graph tags its flags anew. A scratch grows when
a larger call comes, but never while the stream is capturing: before
capturing calls, size it with ``reserve_scratch`` for the largest call of
the graph, on the capturing stream. A scratch a graph has captured is kept
alive when it is replaced. One wrapper call is one C call and one launch;
``ssd_chunk_scan.launches`` counts them. hT is always a fresh tensor: it
never aliases h0.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

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
    fn.argtypes = [p] * 8 + [i] * 6 + [ll] * 9 + [p, ll, i, i, p]
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


EPOCH_WORD = 2  # the scratch's third uint32: the epoch the kernel reads and moves on


class _Scratch:
    """One (device, stream)'s scratch: made zero with its epoch word at 1,
    then left to the kernel. ``captured`` holds every tensor a graph capture
    has used, so that growing never frees a pointer a graph replays."""

    def __init__(self):
        self.tensor: Optional[torch.Tensor] = None
        self.captured: List[torch.Tensor] = []

    def take(self, device, nbytes: int) -> torch.Tensor:
        capturing = torch.cuda.is_current_stream_capturing()
        if self.tensor is None or self.tensor.numel() < nbytes:
            if capturing:
                raise RuntimeError(
                    f"ssd_chunk_scan: the stream's scratch holds "
                    f"{0 if self.tensor is None else self.tensor.numel()} bytes and this call "
                    f"needs {nbytes}; a stream that captures a CUDA graph cannot grow it: call "
                    "ssd.reserve_scratch on that stream before capturing")
            self.tensor = torch.zeros(nbytes, dtype=torch.uint8, device=device)
            self.tensor.view(torch.int32)[EPOCH_WORD] = 1
        if capturing and not any(t is self.tensor for t in self.captured):
            self.captured.append(self.tensor)
        return self.tensor


_SCRATCH: Dict[Tuple[int, int], _Scratch] = {}


def _scratch_of(dev: torch.device, stream) -> _Scratch:
    return _SCRATCH.setdefault((dev.index, stream.cuda_stream), _Scratch())


def reserve_scratch(batch: int, seq: int, nh: int, hd: int, groups: int, ds: int,
                    dtype: torch.dtype = torch.bfloat16, stream=None) -> int:
    """Size ``stream``'s scratch (default: the current stream) for a call of
    these shapes, as a call would grow it. A CUDA graph that captures B5
    calls captures the scratch's pointer, so reserve the largest call of the
    graph on the capturing stream before the capture. Returns the scratch's
    bytes."""
    stream = torch.cuda.current_stream() if stream is None else stream
    dev = stream.device
    nbytes = schedule(batch, seq, nh, hd, groups, ds, DTYPE_CODES[dtype],
                      _sm_count(dev.index))["nbytes"]
    with torch.cuda.stream(stream):
        return _scratch_of(dev, stream).take(dev, nbytes).numel()


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
    stream = torch.cuda.current_stream(dev)
    scratch = _scratch_of(dev, stream).take(dev, nbytes)
    y = torch.empty((Bsz, S, nh, hd), dtype=x.dtype, device=dev)
    hT = torch.empty((Bsz, nh, hd, ds), dtype=torch.float32, device=dev)
    fn, _, err_string = _launcher()
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
             None if h0 is None else h0.data_ptr(), y.data_ptr(), hT.data_ptr(),
             Bsz, S, nh, hd, G, ds, *x.stride()[:3], *Bm.stride()[:3], *dt.stride(),
             scratch.data_ptr(), scratch.numel(), sms, code, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk_scan launch failed: {err_string(err).decode()}")
    ssd_chunk_scan.launches += 1
    return y, hT


ssd_chunk_scan.launches = 0
