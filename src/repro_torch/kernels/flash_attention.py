"""FlashAttention-2 forward: the wrapper of B4.

``flash_attention`` is the port of the JAX package's Pallas kernel of the
same name (``kernels/flash_attention.py``): causal (or full) GQA attention of
each sequence's queries over its own keys, query i at position i. On a CPU
tensor it runs the plain version (``kernels.ref.flash_attention_ref``); on a
CUDA tensor it launches ``csrc/flash_attention.cu`` or raises — it never
falls back. The kernel reads the model's layouts in place: queries
``(B, Sq, H, d)`` contiguous and keys/values ``(B, Sk, KV, d)`` through
their strides, so a prompt's prefix view of a ``(B, max_len, KV, d)`` cache
is read without a copy, and a ragged last query tile is masked in the
kernel rather than padded here. ``flash_attention.launches`` counts
launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import DTYPE_CODES, check_kernel_shape
from repro_torch.kernels.ref import flash_attention_ref

G_MAX = 64  # query heads per KV head: the fp32 kernel holds 64 query vectors per CTA


@functools.cache
def _launcher():
    """The kernel's C entry point, built and loaded on first use."""
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    i, ll = ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [ctypes.c_void_p] * 4 + [i] * 6 + [ll] * 3 + [ctypes.c_float] * 2 \
        + [i] * 3 + [ctypes.c_void_p]
    fn.restype = i
    err = lib.flash_attention_error_string
    err.argtypes, err.restype = [i], ctypes.c_char_p
    return fn, err


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B, Sq, H, d) and k/v (B, Sk, KV, d) of one shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, d = q.shape
    if k.shape[0] != B or k.shape[3] != d or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or not (q.device == k.device == v.device):
        raise TypeError(f"q/k/v differ in dtype or device: {q.dtype}/{k.dtype}/{v.dtype}, "
                        f"{q.device}/{k.device}/{v.device}")
    if not q.is_cuda:
        return
    check_kernel_shape("flash_attention", q.dtype, d, H // k.shape[2], G_MAX)
    vec = 16 // q.element_size()  # the kernel moves 16 bytes at a time
    if not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("q must be contiguous and 16-byte aligned")
    if k.stride() != v.stride() or k.stride(3) != 1 or any(s % vec for s in k.stride()[:3]) \
            or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k and v must share strides, with d contiguous and the other strides "
                         f"and base addresses 16-byte aligned; got {k.stride()}, {v.stride()}")


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, d); k/v: (B, Sk, KV, d), read through their strides
    (d contiguous). Query i attends keys j < Sk with j <= i when ``causal``
    and j > i - ``window`` when given. Returns (B, Sq, H, d)."""
    _check(q, k, v)
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    B, Sq, H, d = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn, err_string = _launcher()
    sb, ss, sh, _ = k.stride()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk, KV, H // KV, d,
             sb, ss, sh, 1.0 / d**0.5, 0.0 if softcap is None else float(softcap),
             0 if window is None else int(window), int(causal), DTYPE_CODES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: {err_string(err).decode()}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
