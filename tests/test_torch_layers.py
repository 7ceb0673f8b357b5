"""The port's layer math against the JAX package's ``models/layers.py`` on
the same numpy inputs, fp32, at 1e-5; and the seeded init's structure and
distribution against ``Model.init``'s."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduce_config as t_reduce_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 7, 64)).astype(np.float32) * 3
    p = {"scale": rng.standard_normal((64,)).astype(np.float32)}
    got = tl.rms_norm(_torch_tree(p), torch.from_numpy(x), 1e-6)
    expect = jl.rms_norm(p, jnp.asarray(x), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)


@pytest.mark.parametrize("rotary_pct", [1.0, 0.5])
@pytest.mark.parametrize("shape", [(9, 4, 16), (2, 9, 4, 16)])  # packed rows / batched
def test_apply_rope(rotary_pct, shape):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    pos = rng.integers(0, 4096, shape[:-2]).astype(np.int32)
    inv_t = tl.rope_freqs(16, rotary_pct, 500000.0)
    inv_j = jl.rope_freqs(16, rotary_pct, 500000.0)
    np.testing.assert_allclose(inv_t.numpy(), np.asarray(inv_j), rtol=1e-6, atol=0)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), inv_t)
    expect = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), inv_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)


@pytest.mark.parametrize("act,glu,bias", [("silu", True, False), ("gelu", False, True)])
def test_ffn(act, glu, bias):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 64)).astype(np.float32)
    p = jl.ffn_init(jax.random.PRNGKey(3), 64, 128, glu=glu, bias=bias)
    p = _np_tree(p)
    if bias:  # non-zero biases, so the add is exercised
        for k in p:
            p[k]["b"] = rng.standard_normal(p[k]["b"].shape).astype(np.float32)
    got = tl.ffn(_torch_tree(p), torch.from_numpy(x), act, glu)
    expect = jl.ffn(p, jnp.asarray(x), act, glu)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)


def test_softcap():
    x = np.linspace(-200, 200, 101, dtype=np.float32)
    got = tl.softcap(torch.from_numpy(x), 30.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(jl.softcap(jnp.asarray(x), 30.0)), **TOL)
    assert tl.softcap(torch.from_numpy(x), None) is not None


def test_init_matches_jax_structure_and_scale():
    """The seeded init builds the same parameter tree as ``Model.init``
    (bridged leaf for leaf), with truncated-normal leaves of the same std."""
    cfg_j = reduce_config(get_config("llama3.1-8b"), periods=2)
    cfg_t = t_reduce_config(t_get_config("llama3.1-8b"), periods=2)
    jparams = _np_tree(jax_build_model(cfg_j).init(jax.random.PRNGKey(0)))
    bridged = from_jax_params(jparams, cfg_t)
    model = build_model(cfg_t, dtype=torch.float32, device="cpu")
    own = model.init(torch.Generator().manual_seed(0))

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)

    assert shapes(own) == shapes(bridged)
    w = own["layers"][0]["ffn"]["up"]["w"]
    std = 1 / np.sqrt(cfg_t.d_model)
    assert abs(float(w.std()) / (std * 0.8796) - 1) < 0.1  # truncated at 2 sigma
    assert float(w.abs().max()) <= 2 * std + 1e-6
    again = model.init(torch.Generator().manual_seed(0))
    assert torch.equal(again["embed"], own["embed"])
