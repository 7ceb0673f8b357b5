"""Shared primitive layers: norms, RoPE, gated FFNs, softcap, inits.

The PyTorch counterpart of the JAX package's ``models/layers.py``, kept
functional: parameters are plain dicts of tensors and every layer is a
function ``(params, x, ...)``. Weight layouts are the JAX ones — a dense
weight is ``(d_in, d_out)`` and applies as ``x @ w`` — so the parameter
bridge (``repro_torch.weights``) copies leaves without transposing.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def truncated_normal(shape, std: float, *, generator: torch.Generator,
                     dtype: torch.dtype, device) -> torch.Tensor:
    """``std * N(0, 1)`` truncated to [-2, 2], drawn in fp32 on ``device``
    from ``generator`` and cast to ``dtype`` (the JAX init's distribution;
    the bits differ, so tests bridge JAX's weights instead)."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.uniform_(lo, hi, generator=generator)
    t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(std)
    return t.to(dtype)


def dense_init(d_in: int, d_out: int, *, generator, dtype, device,
               std: Optional[float] = None, bias: bool = False):
    std = std if std is not None else 1.0 / math.sqrt(d_in)
    p = {"w": truncated_normal((d_in, d_out), std, generator=generator,
                               dtype=dtype, device=device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm_init(d: int, *, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rms_norm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in fp32 and cast back to the input's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Softcap / activations
# ---------------------------------------------------------------------------


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def act_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)


# ---------------------------------------------------------------------------
# RoPE (full / partial "2d")
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, rotary_pct: float, theta: float, *, device="cpu"):
    """Inverse frequencies (fp32) for the rotated prefix of the head dim."""
    rot_dim = int(head_dim * rotary_pct)
    rot_dim -= rot_dim % 2
    if rot_dim == 0:
        return None
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device) / rot_dim
    return 1.0 / (theta ** exps)  # (rot_dim//2,)


def rope_angles(positions: torch.Tensor, inv_freq):
    """(cos, sin) of the fp32 rotation angles, each (..., S, 1, rot/2) — the
    part of RoPE that depends only on positions, so a packed step computes it
    once for all its layers. None without rotary dims."""
    if inv_freq is None:
        return None
    ang = positions[..., None].float() * inv_freq  # (..., S, rot/2)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]  # broadcast over heads


def rotate(x: torch.Tensor, angles) -> torch.Tensor:
    """Apply ``rope_angles`` to x: (..., S, H, head_dim). Rotates the leading
    ``2*rot/2`` dims (half-split convention) in fp32 and passes the rest
    through."""
    if angles is None:
        return x
    cos, sin = angles
    rot = 2 * cos.shape[-1]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    return torch.cat([out, x_pass], dim=-1) if x_pass.shape[-1] else out


def apply_rope(x: torch.Tensor, positions: torch.Tensor, inv_freq) -> torch.Tensor:
    """x: (..., S, H, head_dim); positions: (..., S) integer.

    Rotates the leading ``2*len(inv_freq)`` dims (half-split convention) with
    fp32 angles and passes the rest through — full RoPE and ChatGLM-style
    partial ("2d") RoPE. No Llama-3.1 frequency scaling, like the reference.
    """
    return rotate(x, rope_angles(positions, inv_freq))


# ---------------------------------------------------------------------------
# FFN (SwiGLU / GeGLU / plain)
# ---------------------------------------------------------------------------


def ffn_init(d_model: int, d_ff: int, *, generator, dtype, device,
             glu: bool = True, bias: bool = False):
    kw = dict(generator=generator, dtype=dtype, device=device, bias=bias)
    p = {"up": dense_init(d_model, d_ff, **kw),
         "down": dense_init(d_ff, d_model, **kw)}
    if glu:
        p["gate"] = dense_init(d_model, d_ff, **kw)
    return p


def ffn(p, x: torch.Tensor, act_name: str = "silu", glu: bool = True) -> torch.Tensor:
    a = act_fn(act_name)
    up = dense(p["up"], x)
    h = a(dense(p["gate"], x)) * up if glu else a(up)
    return dense(p["down"], h)
