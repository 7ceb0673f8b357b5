"""Single-query attention over a dense KV cache: the wrapper of B3.

``decode_attention`` is the port of the JAX package's Pallas kernel of the
same name (``kernels/decode_attention.py``): each batch row's one new query,
at position ``lengths[b] - 1``, over its own dense cache ``(B, S, KV, d)``.
On a CPU tensor it runs the plain version (``kernels.ref.decode_attention_ref``);
on a CUDA tensor it launches ``csrc/decode_attention.cu`` or raises — it
never falls back. The cache is read in place through its strides (a
``(B, max_len, KV, d)`` cache is never transposed or padded), so a decode
step moves the live keys and nothing else.

The same CUDA source serves B2 (``paged_attention.paged_attention``): one
kernel, two key-addressing policies. Its keys are split over several CTAs
per (row, KV head) when there are too few rows to fill the card
(``split_count``), with a small combine pass; the split and the fp32
workspace it needs are sized here. ``decode_attention.launches`` counts
launches (one per call, combine included).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_attention_ref

HEAD_DIMS = (16, 32, 64, 128, 256)  # every kernel of the port (B1-B4) takes these
G_MAX = 16  # query heads per KV head (csrc/decode_attention.cu)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SPLIT_TARGET_CTAS = 264  # two CTAs for each of the H100's 132 SMs
MIN_SPLIT_KEYS = 256  # a split streams at least this many keys of its row


@functools.cache
def launchers():
    """The library's C entry points (B3, B2), built and loaded on first use,
    with their ctypes signatures, and its error-string function."""
    lib = _build.load("decode_attention")
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    dense = lib.decode_attention_launch
    dense.argtypes = [p] * 7 + [i, i, ll, ll, ll, i, i, i, i, f, f, i, i, p]
    dense.restype = i
    paged = lib.paged_attention_launch
    paged.argtypes = [p] * 9 + [i] * 8 + [f, f, i, i, p]
    paged.restype = i
    err = lib.decode_attention_error_string
    err.argtypes, err.restype = [i], ctypes.c_char_p
    return dense, paged, err


def split_count(pairs: int, max_keys: int) -> int:
    """CTAs per (row, KV head): enough for ``SPLIT_TARGET_CTAS`` over all
    ``pairs``, but no split shorter than ``MIN_SPLIT_KEYS`` of a row that
    holds ``max_keys``. Each CTA then takes its share of its own row's live
    keys, so short rows leave their later splits empty."""
    want = -(-SPLIT_TARGET_CTAS // max(pairs, 1))
    return max(1, min(want, -(-max_keys // MIN_SPLIT_KEYS)))


def workspace(q: torch.Tensor, n_split: int):
    """The fp32 partial outputs and (m, l) pairs of a split launch, as raw
    pointers (0 when ``n_split == 1``), and the tensor that owns them. The
    caller may drop that tensor once the launch is queued: PyTorch's caching
    allocator hands its memory only to work queued after it on the same
    stream."""
    if n_split == 1:
        return 0, 0, None
    N, KV, G, d = q.shape
    part = torch.empty(N * KV * n_split * G * (d + 2), dtype=torch.float32, device=q.device)
    o_elems = N * KV * n_split * G * d
    return part.data_ptr(), part.data_ptr() + 4 * o_elems, part


def check_kernel_shape(name: str, dtype: torch.dtype, d: int, g: int, g_max: int) -> None:
    """What every attention kernel of the port (B1-B4) takes on the card:
    float32 or bfloat16, a head_dim in ``HEAD_DIMS``, 1..``g_max`` query
    heads per KV head."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: kernel takes float32 or bfloat16, got {dtype}")
    if d not in HEAD_DIMS or not 1 <= g <= g_max:
        raise ValueError(f"{name}: kernel takes head_dim in {HEAD_DIMS} and 1..{g_max} query "
                         f"heads per KV head, got d={d}, G={g}")


def check_query(q: torch.Tensor, lengths: torch.Tensor, name: str):
    """The checks B2 and B3 share: q (N, KV, G, d) contiguous, lengths (N,)
    int32 on q's device; on the card also the kernel's dtypes and shapes."""
    if q.dim() != 4 or not q.is_contiguous():
        raise ValueError(f"{name}: want q as a contiguous (N, KV, G, d), got "
                         f"{tuple(q.shape)}")
    if lengths.dtype != torch.int32 or lengths.shape != (q.shape[0],) \
            or lengths.device != q.device or not lengths.is_contiguous():
        raise ValueError(f"{name}: want lengths as a contiguous ({q.shape[0]},) int32 tensor on "
                         f"{q.device}, got {tuple(lengths.shape)} {lengths.dtype} on "
                         f"{lengths.device}")
    if q.is_cuda:
        check_kernel_shape(name, q.dtype, q.shape[3], q.shape[2], G_MAX)


def _check(q, k, v, lengths):
    check_query(q, lengths, "decode_attention")
    B, KV, G, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (KV, d):
        raise ValueError(f"want k/v caches (B, S, KV, d) matching q {tuple(q.shape)}; got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or not (q.device == k.device == v.device):
        raise TypeError(f"q/k/v differ in dtype or device: {q.dtype}/{k.dtype}/{v.dtype}, "
                        f"{q.device}/{k.device}/{v.device}")
    if q.is_cuda:
        vec = 16 // k.element_size()  # the kernel copies 16 bytes at a time
        if k.stride() != v.stride() or k.stride(3) != 1 \
                or any(s % vec for s in k.stride()[:3]) \
                or k.data_ptr() % 16 or v.data_ptr() % 16:
            raise ValueError("k and v must share strides, with d contiguous and the other "
                             f"strides and base addresses 16-byte aligned; got {k.stride()}, "
                             f"{v.stride()}")


def decode_attention(q, k, v, lengths, *, window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, KV, G, d) one query per row; k/v: (B, S, KV, d) caches, read
    through their strides (d contiguous); lengths: (B,) int32 keys each row
    attends. Returns (B, KV, G, d)."""
    _check(q, k, v, lengths)
    if not q.is_cuda:
        return decode_attention_ref(q, k, v, lengths, window=window, softcap=softcap)
    B, KV, G, d = q.shape
    S = k.shape[1]
    n_split = split_count(B * KV, S)
    out = torch.empty_like(q)
    o_part, ml_part, _keep = workspace(q, n_split)
    dense, _, err_string = launchers()
    sb, ss, sh, _ = k.stride()
    err = dense(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), o_part, ml_part,
                lengths.data_ptr(), B, S, sb, ss, sh, KV, G, d, n_split, 1.0 / d**0.5,
                0.0 if softcap is None else float(softcap), 0 if window is None else int(window),
                DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: {err_string(err).decode()}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
