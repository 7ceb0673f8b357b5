"""Expert choice on bf16 router logits at full router width: the port's
``route`` against the JAX package's top-k and slot positions, on the CPU.

At qwen3-moe-30b-a3b's router (d_model 2048, 128 experts, top 8) and at
jamba-v0.1-52b's (4096, 16 experts, top 2), tokens x ~ N(0, 1) and a router
drawn at the init's std of 0.02, both rounded to bf16, give bf16 logits
whose top-k boundary ties exactly for some tokens. Two checks:

* the same bf16 logits fed to both sides: the port's ``route`` (the logits
  as its input, an identity router, so its product is the logits exactly)
  and JAX's ``_moe_apply_local`` (the same trick, dropless), whose top-k is
  ``jax.lax.top_k`` of the fp32 softmax and whose slot positions are read
  back from where its expert buffer put each token. ``top_i`` and
  ``slot_pos`` must be equal, ties included;
* each side's own bf16 logits from the same bf16 x and router: how often
  the K-th and (K+1)-th logit tie on each side, how many logits differ
  between the sides and how many tokens' choices differ, recorded in
  ``OWN`` (numpy seed 0; the same at one CPU thread and at many). The two
  sides' bf16 products sum in other orders, so a few logits differ, each by
  at most one bf16 step (near zero, a few fp32 steps of the sum); the
  counts of ties and of differing logits are held within a band, since
  another CPU's matmul may round a few others.

Recorded: qwen3-moe's router ties at the top-8 boundary for 269 of 4096
tokens on each side, 121 of its 524,288 logits differ, and no token's
choice differs; jamba's ties for 30 of 4096 tokens, 21 of 65,536 logits
differ, and no token's choice differs.
"""
from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.models.moe as jmoe  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.configs.reduced import dropless  # noqa: E402
import repro_torch.models.moe as tmoe  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs.reduced import dropless as t_dropless  # noqa: E402

N = 4096  # tokens: a 4096-token prompt's rows
STD = 0.02  # the router's init std (moe_init)
ROUTERS = ["qwen3-moe-30b-a3b", "jamba-v0.1-52b"]
# arch -> (tokens whose K-th and (K+1)-th bf16 logits tie: JAX's own, the
# port's own; logits that differ between the two sides; tokens whose top_i
# differ between the two sides' own routings)
OWN = {"qwen3-moe-30b-a3b": (269, 269, 121, 0),
       "jamba-v0.1-52b": (30, 30, 21, 0)}


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).to(torch.bfloat16)


def drawn(arch):
    """(x (N, d), router (d, E)) as bf16 tensors, from numpy seed 0."""
    cfg = t_get_config(arch)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, cfg.d_model)).astype(np.float32)
    w = (rng.standard_normal((cfg.d_model, cfg.n_experts)) * STD).astype(np.float32)
    return _bf16(x), _bf16(w)


def as_jax(t: torch.Tensor):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def port_route(arch, logits: torch.Tensor):
    """The port's (top_i, slot_pos) for bf16 ``logits`` (N, E)."""
    cfg = t_dropless(t_get_config(arch))
    eye = {"w": torch.eye(cfg.n_experts, dtype=torch.bfloat16)}
    _, _, top_i, slot_pos, _ = tmoe.route({"router": eye}, cfg, logits)
    return top_i.numpy(), slot_pos.numpy()


def jax_route(arch, logits: torch.Tensor, monkeypatch):
    """JAX's (top_i, slot_pos) for the same bf16 logits: ``_moe_apply_local``
    on them with an identity router (d_model = E, experts of width 4),
    dropless; slot positions from where its expert buffer put each row."""
    cfg = dropless(dataclasses.replace(get_config(arch), moe_d_ff=4))
    E, K = cfg.n_experts, cfg.top_k
    cfg = dataclasses.replace(cfg, d_model=E)
    seen = []

    def record(a, *axes):
        seen.append(np.asarray(a.astype(jnp.float32)))
        return a

    monkeypatch.setattr(jmoe, "shard_act", record)
    zeros = jnp.zeros((E, E, 4), jnp.bfloat16)
    p = {"router": {"w": jnp.eye(E, dtype=jnp.bfloat16)},
         "experts": {"up": {"w": zeros}, "gate": {"w": zeros},
                     "down": {"w": jnp.zeros((E, 4, E), jnp.bfloat16)}}}
    xf = as_jax(logits)
    jmoe._moe_apply_local(p, cfg, xf[None])
    _, top_i = jax.lax.top_k(jax.nn.softmax(xf.astype(jnp.float32), axis=-1), K)
    top_i = np.asarray(top_i)
    buf = seen[0]  # (E, N + 1, E): row slot_pos of expert top_i holds the token
    rows = {r.tobytes(): n for n, r in enumerate(np.asarray(xf.astype(jnp.float32)))}
    assert len(rows) == N, "the tokens' logits rows must be distinct to read positions back"
    slot_pos = np.full((N, K), -1, np.int64)
    for e in range(E):
        for pos in range(int((top_i == e).sum())):
            n = rows[buf[e, pos].tobytes()]
            k = int(np.nonzero(top_i[n] == e)[0][0])
            slot_pos[n, k] = pos
    return top_i, slot_pos


def boundary_ties(logits: np.ndarray, K: int) -> int:
    """Tokens whose K-th and (K+1)-th largest logits are equal."""
    top = -np.sort(-logits, axis=-1)
    return int((top[:, K - 1] == top[:, K]).sum())


@pytest.mark.parametrize("arch", ROUTERS)
def test_same_bf16_logits_give_jax_choices(arch, monkeypatch):
    cfg = t_get_config(arch)
    x, w = drawn(arch)
    logits = x @ w  # bf16, as route computes them
    assert boundary_ties(logits.float().numpy(), cfg.top_k) > 0, "no tie to test"
    top_i, slot_pos = port_route(arch, logits)
    j_top, j_pos = jax_route(arch, logits, monkeypatch)
    np.testing.assert_array_equal(top_i, j_top)
    np.testing.assert_array_equal(slot_pos, j_pos)


@pytest.mark.parametrize("arch", ROUTERS)
def test_own_bf16_logits_ties_are_the_recorded_ones(arch):
    cfg = t_get_config(arch)
    K = cfg.top_k
    x, w = drawn(arch)
    port = (x @ w).float().numpy()
    jax_logits = np.asarray((as_jax(x) @ as_jax(w)).astype(jnp.float32))
    j_top = np.asarray(jax.lax.top_k(jax.nn.softmax(jnp.asarray(jax_logits), axis=-1), K)[1])
    p_top = port_route(arch, torch.from_numpy(port).to(torch.bfloat16))[0]
    differ = jax_logits != port
    ties_j, ties_p, n_differ, n_choices = OWN[arch]
    assert boundary_ties(jax_logits, K) == pytest.approx(ties_j, rel=0.1)
    assert boundary_ties(port, K) == pytest.approx(ties_p, rel=0.1)
    assert n_differ / 2 <= differ.sum() <= 2 * n_differ
    # a differing logit is at most one bf16 step (8 significant bits) away,
    # or, near zero, where the sum cancels, a few fp32 steps of its terms
    a, b = jax_logits[differ], port[differ]
    assert (np.abs(a - b) <= 2.0**-7 * np.maximum(np.abs(a), np.abs(b)) + 2.0**-18).all()
    assert int((j_top != p_top).any(axis=-1).sum()) == n_choices
