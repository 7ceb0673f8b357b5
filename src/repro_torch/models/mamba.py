"""The Mamba2 (SSD) sequence mixer.

The PyTorch counterpart of the Mamba2 part of the JAX package's
``models/mamba.py``. A prefill (or a one-shot forward) runs the chunked SSD
scan, JAX's ``ssd_chunked``, in B5 (``ops.ssd``; on CPU tensors its plain
version ``kernels.ref.ssd_chunk_ref``); a decode step
(``S == 1`` with a state) is the O(1) recurrent update, plain PyTorch as in
JAX. There is no KV cache: a layer's state is ``{"conv": (B, W-1, conv_ch),
"ssm": (B, nh, hd, ds)}``, both fp32 as JAX keeps them.

Where JAX returns a new state, ``mamba2_apply`` writes the given state in
place and returns it, as the port's attention writes its cache; a caller can
hand it a view of one slot of a larger state. Where JAX pads a ragged prefill
to a multiple of its chunk, the kernel masks the tail itself.

Mamba1 (Jamba's mixer) is not ported yet (ROADMAP.md A9).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import dense, dense_init, rms_norm, truncated_normal

# leaves JAX keeps and uses in fp32 whatever the model's dtype: dt_bias is
# added to the fp32 step sizes and A = -exp(A_log) is taken in fp32, so a
# bf16 copy would change every decay rate
FP32_LEAVES = ("A_log", "dt_bias")


def causal_conv(x, w, b, state=None):
    """x: (B,S,C), w: (W,C), b: (C,). state: (B,W-1,C) carried inputs or None.

    Returns (y, new_state) where new_state holds the last W-1 inputs."""
    W = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)  # (B, S+W-1, C)
    S = x.shape[1]
    y = xp[:, 0:S] * w[0].to(x.dtype)
    for i in range(1, W):
        y = y + xp[:, i:i + S] * w[i].to(x.dtype)
    y = y + b.to(x.dtype)
    return y, xp[:, -(W - 1):]


def _m2_dims(cfg: ModelConfig):
    d_in = cfg.m_expand * cfg.d_model
    nh = d_in // cfg.m_headdim
    return d_in, nh, cfg.m_headdim, cfg.m_n_groups, cfg.m_d_state


def mamba2_init(cfg: ModelConfig, *, generator: torch.Generator, dtype, device):
    """Seeded random parameters with JAX's distributions (``mamba2_init``):
    dense layers 1/sqrt(d_in), the conv kernel std 0.1, A_log = log(1..nh),
    dt_bias the inverse softplus of step sizes log-uniform in [1e-3, 0.1].
    ``FP32_LEAVES`` stay fp32."""
    d_in, nh, hd, G, ds = _m2_dims(cfg)
    conv_ch = d_in + 2 * G * ds
    kw = dict(generator=generator, dtype=dtype, device=device)
    u = torch.empty((nh,), dtype=torch.float32, device=device).uniform_(generator=generator)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(cfg.d_model, 2 * d_in + 2 * G * ds + nh, **kw),
        "conv_w": truncated_normal((cfg.m_conv, conv_ch), 0.1, **kw),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "A_log": torch.log(torch.arange(1, nh + 1, **f32)),
        "D": torch.ones((nh,), dtype=dtype, device=device),
        "dt_bias": torch.log(torch.expm1(dt)),  # softplus^-1
        "norm_scale": torch.ones((d_in,), dtype=dtype, device=device),
        "out_proj": dense_init(d_in, cfg.d_model, **kw),
    }


def mamba2_apply(params, cfg: ModelConfig, u, *, state=None, want_state=False):
    """u: (B,S,d). state: {"conv","ssm"} or None. Returns (y, state|None):
    the given state, updated in place, or with ``want_state`` and no state a
    new one."""
    d_in, nh, hd, G, ds = _m2_dims(cfg)
    B, S, _ = u.shape
    zxbcdt = dense(params["in_proj"], u)
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in:2 * d_in + 2 * G * ds]
    dt_raw = zxbcdt[..., 2 * d_in + 2 * G * ds:]  # (B,S,nh)

    conv_state = state["conv"] if state is not None else None
    xBC, new_conv = causal_conv(xBC, params["conv_w"], params["conv_b"], conv_state)
    xBC = F.silu(xBC)
    # x, B and C stay strided views of xBC: the kernel reads them in place
    x = xBC[..., :d_in].unflatten(-1, (nh, hd))
    B_ = xBC[..., d_in:d_in + G * ds].unflatten(-1, (G, ds))
    C_ = xBC[..., d_in + G * ds:].unflatten(-1, (G, ds))

    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())  # (B,S,nh)
    A = -torch.exp(params["A_log"].float())  # (nh,)

    if S == 1 and state is not None:
        # O(1) recurrent decode step, on the state in place
        a = torch.exp(dt[:, 0] * A)  # (B,nh)
        Bh = B_[:, 0].repeat_interleave(nh // G, dim=1).float()  # (B,nh,ds)
        Ch = C_[:, 0].repeat_interleave(nh // G, dim=1).float()
        dBx = torch.einsum("bh,bhd,bhs->bhds", dt[:, 0], x[:, 0].float(), Bh)
        hT = state["ssm"].mul_(a[..., None, None]).add_(dBx)
        y = torch.einsum("bhds,bhs->bhd", hT, Ch)[:, None].to(u.dtype)  # (B,1,nh,hd)
    else:
        # the chunked SSD scan (JAX's ssd_chunked) is B5; any S, the
        # kernel masks a ragged last chunk
        y, hT = ops.ssd(x, dt, A, B_, C_, state["ssm"] if state is not None else None)

    y = y + params["D"].to(u.dtype)[:, None] * x
    y = y.reshape(B, S, d_in)
    y = y * F.silu(z)
    y = rms_norm({"scale": params["norm_scale"]}, y, cfg.norm_eps)
    out = dense(params["out_proj"], y)
    if state is not None:
        state["conv"].copy_(new_conv)
        if hT is not state["ssm"]:
            state["ssm"].copy_(hT)
        return out, state
    return out, ({"conv": new_conv.float(), "ssm": hT} if want_state else None)


def mamba2_state_init(cfg: ModelConfig, batch: int, *, device) -> dict:
    """Zeroed fp32 state of one Mamba2 layer for ``batch`` rows."""
    d_in, nh, hd, G, ds = _m2_dims(cfg)
    conv_ch = d_in + 2 * G * ds
    return {
        "conv": torch.zeros((batch, cfg.m_conv - 1, conv_ch), dtype=torch.float32, device=device),
        "ssm": torch.zeros((batch, nh, hd, ds), dtype=torch.float32, device=device),
    }
