"""Parameter and KV-cache bridge from the JAX package's trees.

The JAX side hands over plain numpy (``jax.device_get`` of its pytrees), so
this module never sees JAX. Period-stacked leaves — ``stack_init`` stacks
each period position's parameters over the ``n_periods`` axis — are split
back into one entry per layer, in layer order: the prefix layers first,
then period ``c`` position ``i`` as layer ``n_prefix + c * period + i``.
An encoder-decoder's ``enc`` and ``dec`` trees, stacked over their layers,
become lists the same way.
"""
from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.mamba import FP32_LEAVES


def _map(tree, fn: Callable[[Any, str], Any], key: str = ""):
    """``fn(leaf, key)`` over a tree of dicts and lists, ``key`` the dict key
    the leaf sits under."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn, key) for v in tree]
    return fn(tree, key)


def _unstack_layers(stack, cfg: ModelConfig) -> List[Any]:
    """``{"prefix": [...], "periods": {str(i): tree stacked over periods}}``
    -> one tree per layer, in layer order."""
    layers = list(stack["prefix"])
    for c in range(cfg.n_periods):
        for i in range(cfg.scan_period):
            layers.append(_map(stack["periods"][str(i)], lambda a, _, c=c: np.asarray(a)[c]))
    assert len(layers) == cfg.n_layers, (len(layers), cfg.n_layers)
    return layers


def _unstack(tree, n: int) -> List[Any]:
    """A tree stacked over ``n`` layers on axis 0 -> one tree per layer."""
    return [_map(tree, lambda a, _, i=i: np.asarray(a)[i]) for i in range(n)]


def _tensor(dtype, device):
    return lambda a: torch.from_numpy(np.array(a, copy=True)).to(device=device, dtype=dtype)


def from_jax_params(tree, cfg: ModelConfig, *, dtype=torch.float32, device="cpu"):
    """``Model.init``'s parameter pytree (as numpy) -> the port's params, in
    ``dtype`` except the leaves JAX uses in fp32 (``mamba.FP32_LEAVES``).
    Every mixer's leaves cross by name: GQA's, MLA's (``q_down``,
    ``q_norm``, ``q_up``, ``kv_down``, ``kv_norm``, ``kv_up``, ``wo``),
    Mamba2's and Mamba1's (``in_proj``, ``conv_w``, ``conv_b``, ``x_proj``,
    ``dt_proj`` with its bias, ``A_log``, ``D``, ``out_proj``), at any scan
    period (jamba's is 8)."""
    cast, f32 = _tensor(dtype, device), _tensor(torch.float32, device)

    def conv(a, key):
        return f32(a) if key in FP32_LEAVES else cast(a)

    if cfg.encdec:  # encdec_init's tree: enc and dec stacked over layers
        return {"enc": [_map(p, conv) for p in _unstack(tree["enc"], cfg.n_enc_layers)],
                "dec": [_map(p, conv) for p in _unstack(tree["dec"], cfg.n_layers)],
                **{k: _map(tree[k], conv) for k in ("enc_norm", "dec_norm", "embed",
                                                    "pos_dec")}}
    params = {
        "embed": cast(tree["embed"]),
        "layers": [_map(layer, conv) for layer in _unstack_layers(tree["stack"], cfg)],
        "final_norm": _map(tree["final_norm"], conv),
    }
    for key in ("lm_head", "pos"):  # untied heads; learned positions
        if key in tree:
            params[key] = cast(tree[key])
    return params


def caches_from_jax(cache, cfg: ModelConfig, *, dtype=torch.float32, device="cpu"):
    """A JAX per-layer cache tree (as numpy: ``{"prefix": [...], "periods":
    {str(i): tree stacked over periods}}``) -> the port's per-layer list. It
    fits the layouts the JAX package builds with ``stack_cache_init``: the
    paged engine's pool (leaves ``(pages, page, KV, d)``; MLA's ``{"ckv",
    "krope"}`` of ``(pages, page, .)``), the dense cache of
    ``Model.init_cache`` (``{"k","v"}`` of ``(batch, max_len, KV, d)``;
    MLA's latent of ``(batch, max_len, .)``) in ``dtype``, and the Mamba
    layers' ``{"conv", "ssm"}`` state, which stays fp32 as JAX keeps it. For
    an encoder-decoder, ``dec_cache_init``'s ``{"self", "cross"}`` tree
    (each stacked over the decoder layers) becomes one flat dict a layer,
    ``{"k", "v", "cross_k", "cross_v"}``."""
    cast, f32 = _tensor(dtype, device), _tensor(torch.float32, device)
    if cfg.encdec:
        return [{"k": cast(s["k"]), "v": cast(s["v"]),
                 "cross_k": cast(c["k"]), "cross_v": cast(c["v"])}
                for s, c in zip(_unstack(cache["self"], cfg.n_layers),
                                _unstack(cache["cross"], cfg.n_layers))]

    def conv(a, key):
        return f32(a) if key in ("conv", "ssm") else cast(a)

    return [_map(layer, conv) for layer in _unstack_layers(cache, cfg)]
