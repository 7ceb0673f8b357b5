"""Packed forward step: prefill-chunk tokens + decode tokens in ONE pass.

The PyTorch counterpart of the JAX package's ``core/packed_step.py``. The
step takes a flat token set — one token per decoding request plus chunks of
prefilling requests — and runs every linear and FFN op (a MoE FFN routes
the N rows as one batch) over the packed (N, d) token matrix, so the weights
stream from device memory once per step.
Every row's new K/V is written first, then one attention call serves all
rows. Two realizations, one view class each:

  * ``PagedView``: KV in a physical page pool, written through the engine's
    block tables; ONE mixed-batch ragged call
    (``kernels.paged_attention.mixed_paged_attention``, B1) serves decode
    rows and prefill chunks together, each segment reading only its own
    pages up to its own positions.
  * ``DenseView``: the dense fallback. KV in a ``(n_slots + 1, max_len,
    KV, d)`` slot cache, written at (slot, position); ONE one-query-per-row
    call (``kernels.paged_attention.paged_attention``, B2) with each slot's
    row as one page of ``max_len`` tokens (table ``slots[:, None]``,
    ``lengths = positions + 1``), the rows of a prefill chunk sharing tiles
    (``row_tiles``) so that the kernel reads their slot's keys once per
    tile. Keys past a row's position may hold an earlier request's tokens;
    the kernel never reads them.

MLA (``_packed_mla``) writes each row's latent (``ckv``, ``krope``) the
same way and attends in the latent space through the view's
``attend_latent``: plain PyTorch, no kernel, in key tiles with an online
softmax (``attention.latent_attention``). Where JAX gathers every row's
whole latent context (``cc[tables]`` per row, or ``cc[slots]``), the paged
view gathers each segment's context once and each row reads one key tile
of it at a time; the dense view reads its slot's rows a key tile at a
time. A step never holds more than one tile's scores.

Where JAX rebuilt the cache (``.at[...].set``), the port writes it in place
(``index_put_``): ``packed_step`` mutates the cache it is given and returns
that same list. A Python loop over layers replaces ``lax.scan``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels.paged_attention import mixed_paged_attention, paged_attention
from repro_torch.models import attention
from repro_torch.models.layers import dense, ffn, rms_norm, rope_angles, rotate
from repro_torch.models.model import Model
from repro_torch.models.moe import moe_apply


def supports_packed(cfg: ModelConfig) -> bool:
    return (not cfg.encdec) and all(s.mixer == "attn" for s in cfg.layer_specs)


@dataclasses.dataclass
class PagedView:
    """One packed step's paged-attention metadata, built once per step and
    shared by every layer.

    ``block_tables`` is the engine's mirror of the allocator's tables, one
    row per scheduler slot plus the scratch slot, carrying real physical
    page ids and sliced to the ``nb`` columns this step needs; dead entries
    name the scratch page. The segment layout (``cu_q_lens`` / ``kv_lens`` /
    ``seg_slots``) holds decode rows first (one 1-token segment each), then
    one segment per prefill chunk, then zero-width padding segments owned by
    the scratch slot. ``tiles`` is the kernel's q-tile list, required on the
    card."""

    block_tables: torch.Tensor  # (n_slots+1, nb) int32 physical page ids
    page_size: int
    cu_q_lens: torch.Tensor  # (S+1,) int32 packed-row offsets
    kv_lens: torch.Tensor  # (S,) int32 keys per segment
    seg_slots: torch.Tensor  # (S,) int32 owning slot per segment
    tiles: Optional[torch.Tensor] = None  # (n_tiles, 2) int32, see q_tiles

    def __post_init__(self):
        # per-segment tables: each segment reads through its slot's table
        self._seg_tables = self.block_tables[self.seg_slots.long()].contiguous()

    def seg_tables(self) -> torch.Tensor:
        return self._seg_tables

    def write_index(self, slots: torch.Tensor,
                    positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Where each row's new K/V goes: token at logical position p of
        slot s lands in physical page ``table[s, p // page]`` at offset
        ``p % page``. The scheduler grew the tables at plan time, so the
        target pages always exist."""
        pos = positions.long()
        pages = self.block_tables[slots.long(), pos // self.page_size].long()
        return pages, pos % self.page_size

    @staticmethod
    def scatter(pool: torch.Tensor, index, values: torch.Tensor) -> None:
        """Write ``values`` (N, KV, d) into ``pool`` at ``index`` (from
        ``write_index``), in place."""
        pool.index_put_(index, values.to(pool.dtype))

    def attend(self, q, k_cache, v_cache, *, window, softcap):
        """q (N, KV, G, d) over the pool: one mixed-batch call (B1)."""
        return mixed_paged_attention(q, k_cache, v_cache, self.cu_q_lens, self.kv_lens,
                                     self.seg_tables(), window=window, softcap=softcap,
                                     tiles=self.tiles)

    def attend_latent(self, q_eff, q_rope, positions, ckv_pool, krope_pool, *, scale):
        """MLA: each row's absorbed query q_eff (N, H, L) and q_rope (N, H,
        rope) over its segment's latent pages, up to its own position. Each
        segment's ``nb`` pages are gathered once; row r then reads its
        segment's keys one tile at a time. Padding rows (past the last
        segment's end) read the last segment's keys; their outputs are
        ignored. Returns o_lat (N, H, L) in q's dtype."""
        N = q_eff.shape[0]
        tabs = self.seg_tables().long()
        n_seg, nb = tabs.shape
        K = nb * self.page_size
        # each segment's latent and RoPE keys side by side, once
        ckr = torch.cat([ckv_pool[tabs], krope_pool[tabs]], dim=-1).view(n_seg, K, -1)
        rows = torch.arange(N, device=q_eff.device)
        seg = torch.searchsorted(self.cu_q_lens[1:].long(), rows, right=True).clamp_(
            max=n_seg - 1)
        dt = q_eff.dtype
        tile = attention.mla_key_tile(N, q_eff.shape[1], K, ckr.shape[-1], ckr.element_size())
        return attention.latent_attention(
            q_eff[:, None], q_rope[:, None], positions.view(N, 1),
            lambda k0, k1: ckr[seg, k0:k1].to(dt), K, scale=scale, tile=tile)[:, 0]


@dataclasses.dataclass
class DenseView:
    """One packed step's dense-cache attention metadata, built once per
    step and shared by every layer: the rows' slots and positions, and
    B2's row tiles (``row_tiles(slots[:, None], positions + 1, G)``),
    required on the card."""

    slots: torch.Tensor  # (N,) int32
    positions: torch.Tensor  # (N,) int32
    tiles: Optional[torch.Tensor] = None  # (n_tiles, 2) int32, see row_tiles

    def __post_init__(self):
        self._lengths = (self.positions + 1).to(torch.int32)
        self._tables = self.slots.to(torch.int32).view(-1, 1)

    def write_index(self, slots: torch.Tensor,
                    positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Token at position p of slot s lands in cache row s, offset p."""
        return slots.long(), positions.long()

    scatter = staticmethod(PagedView.scatter)

    def attend(self, q, k_cache, v_cache, *, window, softcap):
        """q (N, KV, G, d), one query per row, over its slot's cache row: one
        call (B2), each row a page of ``max_len`` tokens."""
        return paged_attention(q, k_cache, v_cache, self._lengths, self._tables, window=window,
                               softcap=softcap, tiles=self.tiles)

    def attend_latent(self, q_eff, q_rope, positions, ckv_cache, krope_cache, *, scale):
        """MLA: each row's absorbed query q_eff (N, H, L) and q_rope (N, H,
        rope) over its slot's latent row, up to its own position, read one
        key tile at a time. Returns o_lat (N, H, L) in q's dtype."""
        N = q_eff.shape[0]
        S = ckv_cache.shape[1]
        slots, dt = self.slots.long(), q_eff.dtype
        tile = attention.mla_key_tile(N, q_eff.shape[1], S,
                                      ckv_cache.shape[-1] + krope_cache.shape[-1],
                                      ckv_cache.element_size())
        return attention.latent_attention(
            q_eff[:, None], q_rope[:, None], positions.view(N, 1),
            lambda k0, k1: torch.cat([ckv_cache[slots, k0:k1], krope_cache[slots, k0:k1]],
                                     dim=-1).to(dt), S, scale=scale, tile=tile)[:, 0]


def _packed_gqa(p, cfg: ModelConfig, spec: LayerSpec, x, angles, cache, view, write_index):
    N = x.shape[0]
    hd, KV = cfg.head_dim, cfg.n_kv_heads
    G = cfg.n_heads // KV
    q = dense(p["wq"], x).view(N, cfg.n_heads, hd)
    k = dense(p["wk"], x).view(N, KV, hd)
    v = dense(p["wv"], x).view(N, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    q = rotate(q, angles)
    k = rotate(k, angles)
    window = cfg.local_window if spec.attn_kind == "local" else None
    view.scatter(cache["k"], write_index, k)
    view.scatter(cache["v"], write_index, v)
    o = view.attend(q.reshape(N, KV, G, hd).to(cache["k"].dtype).contiguous(), cache["k"],
                    cache["v"], window=window, softcap=cfg.attn_logit_softcap)
    return dense(p["wo"], o.reshape(N, cfg.n_heads * hd).to(x.dtype))


def _packed_mla(p, cfg: ModelConfig, x, positions, angles, cache, view, write_index):
    """JAX's ``_packed_mla``: every row's latent is written first, then each
    row attends in the latent space (absorbed: q_nope through the keys' half
    of ``kv_up``, the output through its values' half)."""
    N = x.shape[0]
    H, L = cfg.n_heads, cfg.kv_lora_rank
    nope, rope, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope, ckv, krope = attention.mla_qkv_rope(p, cfg, x, angles)
    view.scatter(cache["ckv"], write_index, ckv)
    view.scatter(cache["krope"], write_index, krope)
    w_up = p["kv_up"]["w"].view(L, H, nope + vh).to(x.dtype)
    q_eff = torch.einsum("nhp,lhp->nhl", q_nope, w_up[..., :nope])
    o_lat = view.attend_latent(q_eff, q_rope, positions, cache["ckv"], cache["krope"],
                               scale=1.0 / ((nope + rope) ** 0.5))
    o = torch.einsum("nhl,lhv->nhv", o_lat, w_up[..., nope:]).reshape(N, H * vh)
    return dense(p["wo"], o)


def _packed_layer(p, cfg: ModelConfig, spec: LayerSpec, x, positions, angles, cache, view,
                  write_index):
    hn = rms_norm(p["norm1"], x, cfg.norm_eps)
    if cfg.mla:
        y = _packed_mla(p["mixer"], cfg, hn, positions, angles, cache, view, write_index)
    else:
        y = _packed_gqa(p["mixer"], cfg, spec, hn, angles, cache, view, write_index)
    if cfg.post_norm:
        y = rms_norm(p["post_norm1"], y, cfg.norm_eps)
    x = x + y
    if spec.ffn != "none":
        hn = rms_norm(p["norm2"], x, cfg.norm_eps)
        if spec.ffn == "dense":
            y = ffn(p["ffn"], hn, cfg.act, cfg.glu)
        else:
            y = moe_apply(p["ffn"], cfg, hn[None])[0][0]  # (1, N, d) -> (N, d)
        if cfg.post_norm:
            y = rms_norm(p["post_norm2"], y, cfg.norm_eps)
        x = x + y
    return x


@torch.inference_mode()
def packed_step(model: Model, params, cache, tokens, slots, positions,
                view: Optional[Union[PagedView, DenseView]] = None):
    """tokens/slots/positions: (N,) -> (logits (N, vocab) fp32, cache).

    With a ``PagedView`` the cache is the per-layer page pool list
    (``Model.init_page_pool``); padding rows point at the scratch slot, whose
    table names only the scratch page, and their outputs are ignored by the
    caller. With a ``DenseView`` (or none: ``DenseView(slots, positions)``,
    without row tiles, which only the CPU takes) the cache is the dense slot
    cache (``Model.init_cache(n_slots + 1, max_len)``). Either is updated in
    place and returned."""
    cfg = model.cfg
    if not supports_packed(cfg):
        raise NotImplementedError(f"{cfg.name}: not a packed (attention-only) arch")
    if view is None:
        view = DenseView(slots, positions)
    x = model._embed(params, tokens)
    # what every layer shares is computed once: the K/V write targets and
    # the RoPE angles of the step's positions
    write_index = view.write_index(slots, positions)
    angles = rope_angles(positions, model.inv_freq)
    for p, spec, layer_cache in zip(params["layers"], cfg.layer_specs, cache):
        x = _packed_layer(p, cfg, spec, x, positions, angles, layer_cache, view, write_index)
    return model._head(params, rms_norm(params["final_norm"], x, cfg.norm_eps)), cache
