"""Mixture-of-Experts channel mixer: top-k router + capacity-based dispatch.

The PyTorch counterpart of the JAX package's ``models/moe.py`` on one device
(``_moe_apply_local``). Dispatch is GShard-style scatter/gather with a fixed
per-expert capacity ``C``: tokens go to an ``(E, C + 1, d)`` buffer (row
``C`` of each expert is an overflow row that dropped tokens write and
nothing reads), the expert FFNs run as three batched products over it, and
each token gathers its K rows back, weighted by its router weights. Under
``configs.reduced.dropless`` (serving) ``C = N`` and nothing is dropped.

Every shape depends only on the token count ``N``: there is no host sync and
no per-expert Python loop on the step, so a step can be captured in a CUDA
graph. JAX walks the K slots one at a time to give each (token, slot) its
position in its expert's buffer; here one ``cumsum`` along the slot-major
flattening ``(E, K * N)`` of the one-hot choices gives the same positions
(earlier slots first, then earlier tokens).

The expert-parallel path (``_moe_apply_sharded``, a ``shard_map`` over the
"model" mesh axis) waits for distributed serving (ROADMAP.md A11).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, ffn, ffn_init, truncated_normal


def moe_init(cfg: ModelConfig, *, generator, dtype, device):
    """``{"router": {"w"}, "experts": ffn_init's leaves stacked on a leading
    E axis, "shared": an FFN if n_shared_experts}``. Each expert is drawn in
    fp32 into its slice of the preallocated ``(E, ., .)`` leaves, so the
    device holds a layer's experts once (plus one expert's fp32 draw)."""
    kw = dict(generator=generator, dtype=dtype, device=device)
    E, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    shapes = {"up": (d, f), "down": (f, d)}
    if cfg.glu:
        shapes["gate"] = (d, f)
    experts = {k: {"w": torch.empty((E,) + s, dtype=dtype, device=device)}
               for k, s in shapes.items()}
    for e in range(E):
        for k, shape in shapes.items():  # ffn_init's order and std
            experts[k]["w"][e] = truncated_normal(shape, 1.0 / math.sqrt(shape[0]), **kw)
    p = {"router": dense_init(d, E, std=0.02, **kw), "experts": experts}
    if cfg.n_shared_experts:
        p["shared"] = ffn_init(d, cfg.shared_d_ff, glu=cfg.glu, **kw)
    return p


def expert_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    cf = cfg.moe_capacity_factor
    if cf >= cfg.n_experts:  # dropless: one expert could receive every token,
        return n_tokens      # but at most once each (top-k indices distinct)
    c = math.ceil(cfg.top_k * n_tokens / cfg.n_experts * cf)
    return max(4, -(-c // 4) * 4)  # >=4, multiple of 4


def route(p, cfg: ModelConfig, xf: torch.Tensor):
    """The router's decision for ``xf`` (N, d): probs (N, E) fp32, top_w
    (N, K) in xf's dtype, top_i (N, K), slot_pos (N, K) (each (token,
    slot)'s position in its expert's buffer, earlier slots first) and each
    expert's count of slot-0 choices (E,)."""
    N = xf.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    logits = (xf @ p["router"]["w"].to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    # largest first, and of equal probabilities the lower expert first, as
    # jax.lax.top_k orders them (torch.topk leaves ties in no set order;
    # bf16 logits tie often at 128 experts)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :K], top_i[:, :K]
    if cfg.norm_topk:
        top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    # slot-major: column k * N + n is token n's k-th choice, so the
    # exclusive running count along each expert's row gives slot k's
    # position after every earlier slot's tokens and slot k's earlier tokens
    # (a scan along the innermost dim: one row an expert)
    choice = top_i.T.reshape(1, K * N)
    oh = (torch.arange(E, device=xf.device)[:, None] == choice).to(torch.int32)  # (E, K N)
    before = torch.cumsum(oh, dim=1, dtype=torch.int32) - oh
    slot_pos = before.gather(0, choice).view(K, N).T
    return probs, top_w.to(xf.dtype), top_i, slot_pos, oh[:, :N].sum(dim=1)


def moe_apply(p, cfg: ModelConfig, x: torch.Tensor):
    """x: (B, T, d) -> (y (B, T, d), aux loss (fp32 scalar)). Tokens over an
    expert's capacity keep only the residual (and the shared experts)."""
    B, T, d = x.shape
    N = B * T
    E, K = cfg.n_experts, cfg.top_k
    xf = x.reshape(N, d)
    probs, top_w, top_i, slot_pos, first = route(p, cfg, xf)
    C = expert_capacity(N, cfg)
    keep = slot_pos < C
    flat_idx = (top_i * (C + 1) + slot_pos.clamp(max=C)).reshape(N * K)

    # row C of each expert takes the dropped tokens' writes (any of them:
    # duplicates go there only) and is never read
    buf = torch.zeros((E * (C + 1), d), dtype=xf.dtype, device=xf.device)
    buf.index_copy_(0, flat_idx, xf[:, None, :].expand(N, K, d).reshape(N * K, d))
    ye = ffn(p["experts"], buf.view(E, C + 1, d), cfg.act, cfg.glu)  # batched over E

    gathered = ye.view(E * (C + 1), d)[flat_idx].view(N, K, d)
    w = (top_w * keep.to(top_w.dtype))[..., None]
    y = (gathered * w).sum(dim=1)
    if cfg.n_shared_experts:
        y = y + ffn(p["shared"], xf, cfg.act, cfg.glu)

    # Switch load-balance loss: E * sum(mean router prob * slot-0 dispatch share)
    aux = E * torch.sum(probs.mean(dim=0) * first.float() / max(N, 1))
    return y.view(B, T, d), aux
