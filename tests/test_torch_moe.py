"""The port's MoE channel mixer (``repro_torch.models.moe``) against the JAX
package's ``_moe_apply_local`` on the CPU, in fp32, on the same numpy-seeded
inputs and parameters, at qwen3-moe-30b-a3b's reduced widths (d_model 64, 8
experts of width 64, top 2) and at its published K = 8 over 16 experts.

Besides y (rtol = atol = 1e-5) and the auxiliary loss (1e-6), each case
compares the dispatch itself: JAX's expert buffer, caught where
``_moe_apply_local`` hands it to ``shard_act``, against the port's, caught
where ``moe_apply`` hands it to the experts' ``ffn`` (rows 0..C-1; row C is
the overflow row, written by dropped tokens and never read). JAX's top-k
indices come from its own router, and its ``keep`` mask from where its
buffer put each token. A case at JAX's default capacity factor of 1.25
drops tokens, so slot priority and the overflow row show.

A near-tie between the K-th and (K+1)-th router probability could flip an
expert without a fault; each case's smallest such margin is recorded in
``CASES`` (its seed chosen for it) and must stay far above fp32's drift.
Exact ties are another matter: the port orders them as ``jax.lax.top_k``
does, the lower expert first, and one test ties every token's top two.

Each fault is a one-line mutation of the port's module source, run through
the same comparison, which must reject it: later slots given priority,
``norm_topk`` ignored, shared experts left out, the overflow row read back.
"""
from __future__ import annotations

import dataclasses
import inspect
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.models.moe as jmoe  # noqa: E402
from repro.configs import get_config, reduce_config  # noqa: E402
from repro.configs.reduced import dropless  # noqa: E402
import repro_torch.models.moe as tmoe  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduce_config as t_reduce_config  # noqa: E402
from repro_torch.configs.reduced import dropless as t_dropless  # noqa: E402

Y_TOL = dict(rtol=1e-5, atol=1e-5)
AUX_TOL = dict(rtol=1e-6, atol=1e-6)
FAULT_MARGIN = 100  # a fault moves some output this many tolerances
ARCH = "qwen3-moe-30b-a3b"
B, T = 2, 32
# case -> (config changes, dropless, seed, smallest K-th vs (K+1)-th router
# probability margin over the case's tokens); each seed chosen among 0..9
# for the largest margin (in the capacity cases, among seeds that drop at
# least 10 of the (token, slot) pairs)
CASES = {
    "dropless": (dict(), True, 6, 0.001537),
    "drops_cf1.25": (dict(), False, 4, 0.001372),
    "no_norm_topk": (dict(norm_topk=False), True, 6, 0.001537),
    "shared": (dict(n_shared_experts=2, shared_d_ff=64), False, 9, 0.003732),
    "published_k8_e16": (dict(n_experts=16, top_k=8), False, 1, 0.000277),
}


def configs(case):
    over, drop, _, _ = CASES[case]
    cfg_j = dataclasses.replace(reduce_config(get_config(ARCH)), **over)
    cfg_t = dataclasses.replace(t_reduce_config(t_get_config(ARCH)), **over)
    return (dropless(cfg_j), t_dropless(cfg_t)) if drop else (cfg_j, cfg_t)


def inputs(case):
    """(x (B, T, d), parameters as numpy) from the case's seed. The router
    is drawn at std 1/sqrt(d), wider than the init's 0.02, so that the
    top-k choices are far from ties, and the tokens share an offset, so that
    some experts are favoured and the capacity cases drop tokens."""
    cfg = configs(case)[1]
    rng = np.random.default_rng(CASES[case][2])
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)

    p = {"router": {"w": w(d, E)},
         "experts": {"up": {"w": w(E, d, f)}, "gate": {"w": w(E, d, f)},
                     "down": {"w": w(E, f, d)}}}
    if cfg.n_shared_experts:
        sf = cfg.shared_d_ff
        p["shared"] = {"up": {"w": w(d, sf)}, "gate": {"w": w(d, sf)}, "down": {"w": w(sf, d)}}
    x = rng.standard_normal((B, T, d)) + 0.5 * rng.standard_normal(d)
    return x.astype(np.float32), p


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in p.items()}


def run_jax(case, monkeypatch):
    """(y, aux, the expert buffer (E, C + 1, d)) of ``_moe_apply_local``."""
    cfg, _ = configs(case)
    x, p = inputs(case)
    seen = []

    def record(a, *axes):
        seen.append(np.asarray(a))
        return a

    monkeypatch.setattr(jmoe, "shard_act", record)
    y, aux = jmoe._moe_apply_local(_tree(p, jnp.asarray), cfg, jnp.asarray(x))
    return np.asarray(y), float(aux), seen[0]


def run_port(case, monkeypatch, module=tmoe):
    """(y, aux, the expert buffer, route's outputs) of the port's
    ``moe_apply`` (or of a mutated copy of its module)."""
    _, cfg = configs(case)
    x, p = inputs(case)
    seen = {}
    ffn = module.ffn

    def record(pp, h, *args):
        if h.dim() == 3:
            seen["buf"] = h.clone()
        return ffn(pp, h, *args)

    monkeypatch.setattr(module, "ffn", record)
    y, aux = module.moe_apply(_tree(p, torch.from_numpy), cfg, torch.from_numpy(x))
    xf = torch.from_numpy(x).reshape(B * T, -1)
    routed = module.route(_tree(p, torch.from_numpy), cfg, xf)
    return y.numpy(), float(aux), seen["buf"].numpy(), routed


def jax_routing(case, buf):
    """JAX's top-k indices, from its own router, and its keep mask, from
    where its buffer (rows 0..C-1) put each (token, slot)."""
    cfg, _ = configs(case)
    x, p = inputs(case)
    rows = x.reshape(B * T, -1)
    logits = jnp.asarray(rows) @ jnp.asarray(p["router"]["w"])
    _, top_i = jax.lax.top_k(jax.nn.softmax(logits.astype(jnp.float32), axis=-1), cfg.top_k)
    top_i = np.asarray(top_i)
    C = buf.shape[1] - 1
    keep = np.array([[np.any(np.all(buf[e, :C] == rows[n], axis=-1)) for e in top_i[n]]
                     for n in range(B * T)])
    return top_i, keep


def margin(probs, K):
    """The smallest gap between each token's K-th and (K+1)-th probability."""
    top = torch.topk(probs, K + 1, dim=-1).values
    return float((top[:, K - 1] - top[:, K]).min())


@pytest.mark.parametrize("case", list(CASES))
def test_moe_matches_jax(case, monkeypatch):
    jy, jaux, jbuf = run_jax(case, monkeypatch)
    ty, taux, tbuf, (probs, _, top_i, slot_pos, _) = run_port(case, monkeypatch)
    np.testing.assert_allclose(ty, jy, **Y_TOL)
    np.testing.assert_allclose(taux, jaux, **AUX_TOL)
    cfg = configs(case)[1]
    C = tmoe.expert_capacity(B * T, cfg)
    assert jbuf.shape == tbuf.shape == (cfg.n_experts, C + 1, cfg.d_model)
    np.testing.assert_array_equal(tbuf[:, :C], jbuf[:, :C])
    j_top, j_keep = jax_routing(case, jbuf)
    np.testing.assert_array_equal(top_i.numpy(), j_top)
    keep = (slot_pos < C).numpy()
    np.testing.assert_array_equal(keep, j_keep)
    if CASES[case][1]:
        assert C == B * T and keep.all()
    else:
        assert (~keep).sum() >= 10, "a capacity case must drop tokens"
    m = margin(probs, cfg.top_k)
    assert m == pytest.approx(CASES[case][3], abs=1e-6)
    assert m > 1e-4


def mutated(replacements):
    """A copy of the port's MoE module with each (old, new) source
    replacement made; each old text must be in the source."""
    src = inspect.getsource(tmoe)
    for old, new in replacements:
        assert old in src, old
        src = src.replace(old, new)
    module = types.ModuleType("moe_fault")
    exec(compile(src, "moe_fault", "exec"), module.__dict__)
    return module


FAULTS = {
    # positions counted with slot K-1 first: later slots take the room
    "later_slots_first": ("drops_cf1.25", [
        ("choice = top_i.T.reshape", "choice = top_i.flip(1).T.reshape"),
        (".view(K, N).T\n", ".view(K, N).T.flip(1)\n")]),
    "norm_topk_ignored": ("drops_cf1.25", [("if cfg.norm_topk:", "if False:")]),
    "shared_left_out": ("shared", [("if cfg.n_shared_experts:\n        y = y",
                                    "if False:\n        y = y")]),
    "overflow_read_back": ("drops_cf1.25", [("keep = slot_pos < C", "keep = slot_pos <= C")]),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_moe_fault_is_rejected(fault, monkeypatch):
    case, replacements = FAULTS[fault]
    jy, _, _ = run_jax(case, monkeypatch)
    ty, _, _, _ = run_port(case, monkeypatch, mutated(replacements))
    moved = np.abs(ty - jy).max() / (Y_TOL["atol"] + Y_TOL["rtol"] * np.abs(jy).max())
    assert moved > FAULT_MARGIN, moved


def test_unmutated_copy_passes(monkeypatch):
    """The mutation harness itself: a copy with no replacement matches."""
    jy, _, _ = run_jax("drops_cf1.25", monkeypatch)
    ty, _, _, _ = run_port("drops_cf1.25", monkeypatch, mutated([]))
    np.testing.assert_allclose(ty, jy, **Y_TOL)


@pytest.mark.parametrize("n", [1, 7, 64, 520, 4096])
@pytest.mark.parametrize("case", list(CASES))
def test_expert_capacity_matches_jax(case, n):
    cfg_j, cfg_t = configs(case)
    assert tmoe.expert_capacity(n, cfg_t) == jmoe.expert_capacity(n, cfg_j)


@pytest.mark.parametrize("case", ["dropless", "shared", "no_norm_topk"])
def test_moe_init_tree_matches_jax(case):
    """``moe_init`` makes JAX's tree, leaf for leaf in shape, with the
    experts stacked on a leading E axis, in the given dtype."""
    cfg_j, cfg_t = configs(case)
    want = jax.tree.map(lambda a: tuple(a.shape), jmoe.moe_init(jax.random.PRNGKey(0), cfg_j))
    got = tmoe.moe_init(cfg_t, generator=torch.Generator().manual_seed(0),
                        dtype=torch.bfloat16, device="cpu")
    assert _tree(got, lambda t: tuple(t.shape)) == want
    leaves = [got["experts"][k]["w"] for k in ("up", "gate", "down")]
    assert all(t.dtype == torch.bfloat16 for t in leaves)
    # each expert drawn on its own: no two experts' slices alike
    up = got["experts"]["up"]["w"].float()
    assert all(not torch.equal(up[0], up[e]) for e in range(1, cfg_t.n_experts))
    std = float(up.std())
    assert 0.7 / np.sqrt(cfg_t.d_model) < std < 1.0 / np.sqrt(cfg_t.d_model)


def test_exact_ties_take_the_lower_expert(monkeypatch):
    """Experts e and e + 4 share a router column, so every token's top two
    tie exactly; like ``jax.lax.top_k``, the port takes the lower expert
    first, so slot priority and the dropped pairs match too (capacity 1.25,
    where the tied second slot is the one dropped)."""
    case = "drops_cf1.25"
    x, p = inputs(case)
    p["router"]["w"][:, 4:] = p["router"]["w"][:, :4]
    monkeypatch.setitem(globals(), "inputs", lambda _case: (x, p))
    jy, _, jbuf = run_jax(case, monkeypatch)
    ty, _, tbuf, (_, _, top_i, slot_pos, _) = run_port(case, monkeypatch)
    np.testing.assert_allclose(ty, jy, **Y_TOL)
    j_top, j_keep = jax_routing(case, jbuf)
    np.testing.assert_array_equal(top_i.numpy(), j_top)
    assert (top_i[:, 1] == top_i[:, 0] + 4).all()
    C = tmoe.expert_capacity(B * T, configs(case)[1])
    np.testing.assert_array_equal(tbuf[:, :C], jbuf[:, :C])
    np.testing.assert_array_equal((slot_pos < C).numpy(), j_keep)
    assert not j_keep.all()
