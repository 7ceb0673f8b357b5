"""State-space sequence mixers: Mamba2 (SSD) and Mamba1 (Jamba's mixer).

The PyTorch counterpart of the JAX package's ``models/mamba.py``. Mamba2: a
prefill (or a one-shot forward) runs the chunked SSD scan, JAX's
``ssd_chunked``, in B5 (``ops.ssd``; on CPU tensors its plain version
``kernels.ref.ssd_chunk_ref``); a decode step (``S == 1`` with a state) is
the O(1) recurrent update, plain PyTorch as in JAX. There is no KV cache:
a layer's state is ``{"conv": (B, W-1, conv_ch), "ssm": (B, nh, hd, ds)}``,
both fp32 as JAX keeps them.

Where JAX returns a new state, ``mamba2_apply`` writes the given state in
place and returns it, as the port's attention writes its cache; a caller can
hand it a view of one slot of a larger state. Where JAX pads a ragged prefill
to a multiple of its chunk, the kernel masks the tail itself.

Mamba1 has no kernel in either package: ``mamba1_apply`` is plain PyTorch,
as MLA's attention is. A decode step (``S == 1`` with a state) is JAX's
recurrent update; anything else is JAX's chunked linear recurrence
(``_m1_scan_chunked``, chunks of ``CHUNK``): within a chunk a log-step
(Hillis-Steele) scan of the pairs ``(a, b)``, combined as ``(a1 a2, a2 b1 +
b2)``, and a Python loop over the chunks carries ``h``. The decays ``a`` and
inputs ``b``, ``(B, L, d_in, ds)`` in fp32, are built one chunk at a time,
so a call's extra memory is a few chunks' worth whatever the segment's
length. A ragged last chunk is simply shorter (JAX pads it with ``a = 1, b =
0``, which leaves ``h`` as it was). Its state is ``{"conv": (B, W-1, d_in),
"ssm": (B, d_in, ds)}``, both fp32, written in place as Mamba2's is.

Mamba1's precision in a bf16 model: fp32 where JAX keeps it (the step sizes
dt, B, C, A = -exp(A_log), the decays and inputs a and b, the state h); the
big projections (``in_proj``, ``out_proj``) in the activations' dtype, as
are the scan's output, rounded as JAX rounds it, and the gated input of
``out_proj``; everything between in fp32, where JAX rounds op by op: the
conv and its silu, the two small projections (``x_proj``, ``dt_proj``) and
the skip and gate (``y + D x``, then ``* silu(z)``, in JAX's order). Every
bf16 rounding moves an element by up to 2^-9 of it, and rounded op by op
JAX's formula misses the kernels' bf16 row allowance of an fp32 reference
at reduced widths on the CPU; the port meets it (``chip_smoke.py``,
``mamba1_layer``, at jamba's widths). An fp32 model computes exactly JAX's
formula.
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
CHUNK = 128  # Mamba1's scan chunk, JAX's


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


# ---------------------------------------------------------------------------
# Mamba1 (Jamba's mixer)
# ---------------------------------------------------------------------------


def _m1_dims(cfg: ModelConfig):
    d_in = cfg.m_expand * cfg.d_model
    dt_rank = math.ceil(cfg.d_model / 16)
    return d_in, dt_rank, cfg.m_d_state_m1


def mamba1_init(cfg: ModelConfig, *, generator: torch.Generator, dtype, device):
    """Seeded random parameters with JAX's distributions (``mamba1_init``):
    dense layers 1/sqrt(d_in) (``dt_proj`` with a zero bias), the conv
    kernel std 0.1, A_log = log(1..ds) for every channel, D ones.
    ``FP32_LEAVES`` stay fp32."""
    d_in, dt_rank, ds = _m1_dims(cfg)
    kw = dict(generator=generator, dtype=dtype, device=device)
    A = torch.arange(1, ds + 1, dtype=torch.float32, device=device)[None, :].repeat(d_in, 1)
    return {
        "in_proj": dense_init(cfg.d_model, 2 * d_in, **kw),
        "conv_w": truncated_normal((cfg.m_conv, d_in), 0.1, **kw),
        "conv_b": torch.zeros((d_in,), dtype=dtype, device=device),
        "x_proj": dense_init(d_in, dt_rank + 2 * ds, **kw),
        "dt_proj": dense_init(dt_rank, d_in, bias=True, **kw),
        "A_log": torch.log(A),
        "D": torch.ones((d_in,), dtype=dtype, device=device),
        "out_proj": dense_init(d_in, cfg.d_model, **kw),
    }


def _m1_scan_chunked(dt, x, A, B_, C_, h, chunk=CHUNK):
    """The linear recurrence h_t = a_t h_{t-1} + b_t, y_t = h_t . C_t, with
    a_t = exp(dt_t A) and b_t = (dt_t x_t) B_t, built chunk by chunk. dt, x:
    (B, S, d_in) fp32; A: (d_in, ds); B_, C_: (B, S, ds) fp32; h: (B, d_in,
    ds) fp32, the state before token 0, overwritten with the state after
    token S. Returns y (B, S, d_in) fp32."""
    S = dt.shape[1]
    ys = []
    for c0 in range(0, S, chunk):
        c1 = min(c0 + chunk, S)
        dtc = dt[:, c0:c1]
        a = torch.exp(dtc[..., None] * A)  # (B, L, d_in, ds)
        b = (dtc * x[:, c0:c1])[..., None] * B_[:, c0:c1, None, :]
        a2, b2 = torch.empty_like(a), torch.empty_like(b)
        # inclusive log-step scan, each pass from one pair of buffers into
        # the other: after the pass of stride s, token t holds the
        # composition of tokens max(0, t - 2s + 1)..t; the first s tokens
        # are copied across unchanged
        step = 1
        while step < c1 - c0:
            torch.addcmul(b[:, step:], a[:, step:], b[:, :-step], out=b2[:, step:])
            torch.mul(a[:, :-step], a[:, step:], out=a2[:, step:])
            b2[:, :step] = b[:, :step]
            a2[:, :step] = a[:, :step]
            a, b, a2, b2 = a2, b2, a, b
            step *= 2
        h_all = b.addcmul_(a, h[:, None])  # (B, L, d_in, ds)
        ys.append(torch.einsum("blds,bls->bld", h_all, C_[:, c0:c1]))
        h.copy_(h_all[:, -1])
        del a, b, a2, b2, h_all
    return torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]


def mamba1_apply(params, cfg: ModelConfig, u, *, state=None, want_state=False):
    """u: (B,S,d). state: {"conv","ssm"} or None. Returns (y, state|None):
    the given state, updated in place, or with ``want_state`` and no state a
    new one."""
    d_in, dt_rank, ds = _m1_dims(cfg)
    B, S, _ = u.shape
    xz = dense(params["in_proj"], u)
    x, z = xz[..., :d_in], xz[..., d_in:]
    conv_state = state["conv"] if state is not None else None
    # x from here on in fp32: the conv, its silu, the two small projections
    # (whose outputs feed only fp32 math: the step sizes, B and C; 4.5 M of
    # a layer's 105 M parameters at jamba's widths), b and the skip D x
    x, new_conv = causal_conv(x.float(), params["conv_w"].float(), params["conv_b"].float(),
                              conv_state)
    x32 = F.silu(x)
    xdbc = x32 @ params["x_proj"]["w"].float()
    dt = F.softplus(xdbc[..., :dt_rank] @ params["dt_proj"]["w"].float()
                    + params["dt_proj"]["b"].float())  # (B,S,d_in)
    B_ = xdbc[..., dt_rank:dt_rank + ds]  # (B,S,ds)
    C_ = xdbc[..., dt_rank + ds:]
    A = -torch.exp(params["A_log"].float())  # (d_in, ds)

    if state is not None:
        h = state["ssm"]
    else:
        h = torch.zeros((B, d_in, ds), dtype=torch.float32, device=u.device)
    if S == 1 and state is not None:
        # O(1) recurrent decode step, on the state in place
        a = torch.exp(dt[:, 0, :, None] * A)  # (B,d_in,ds)
        b = (dt[:, 0] * x32[:, 0])[..., None] * B_[:, 0, None, :]
        hT = h.mul_(a).add_(b)
        y = torch.einsum("bds,bs->bd", hT, C_[:, 0])[:, None]
    else:
        y = _m1_scan_chunked(dt, x32, A, B_, C_, h)

    # JAX's order: the scan's output rounded to the activations' dtype, D x
    # added, the gate applied; the add and the gate in fp32, rounded once
    y = y.to(u.dtype).float() + params["D"].float() * x32
    y = (y * F.silu(z.float())).to(u.dtype)
    out = dense(params["out_proj"], y)
    if state is not None:
        state["conv"].copy_(new_conv)
        return out, state
    return out, ({"conv": new_conv, "ssm": h} if want_state else None)


def mamba1_state_init(cfg: ModelConfig, batch: int, *, device) -> dict:
    """Zeroed fp32 state of one Mamba1 layer for ``batch`` rows."""
    d_in, dt_rank, ds = _m1_dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.m_conv - 1, d_in), dtype=torch.float32, device=device),
        "ssm": torch.zeros((batch, d_in, ds), dtype=torch.float32, device=device),
    }
