"""B3's bf16 cluster, on the CPU.

The launch shape the wrapper picks (``decode_attention.cluster_plan``)
against its Python copy (``ref.cluster_plan``, which ``chip_smoke.py`` holds
the card's launches to) over every shape ``chip_smoke.py`` and the serial
path use and a sweep of row counts and capacities, within the kernel's
limits; the CTA shares (``ref.cluster_shares``) against the split's rules;
then the cluster's algebra done plainly (``ref.decode_cluster_ref``: each
share's (m, l, acc) alone, combined in the kernel's butterfly) against
``ref.decode_attention_ref``, the JAX package's oracle and its Pallas
``decode_attention`` in interpret mode: a window that starts mid-block,
empty shares, a one-key row, a row of exactly C x 64 keys, softcap 50, G 1
to 16, d 16 to 256, NaN in every dead slot. The broken combines
``chip_smoke.py`` must reject are shown to break the result. Inputs from
fixed numpy seeds; fp32; rtol = atol = 2e-5, as ``test_torch_kernels.py``
holds B3 (the sides sum in different orders).
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
CAPS = (64, 600, 4096, 8192, 131072)

# (pairs, cap, d) of every B3 bf16 call in chip_smoke.py and of the serial
# path (one row of Llama3.1-8B's 8 KV heads over an 8192-token cache)
CHIP_SHAPES = [
    (8, 8192, 128),  # b3_serial_bf16, b3_short/one_key/exact_c64_bf16, serial, graph replay
    (64, 8192, 128),  # b3_batch_bf16
    (32, 4096, 128),  # b3_window_softcap_bf16
    (1, 131072, 64),  # b3_long_g16_bf16
    (8, 1024, 16),  # b3_d16_g1_bf16
    (6, 2048, 32),  # b3_d32_g8_bf16
    (2, 4096, 128),  # b3_d128_g12_bf16
    (1, 4096, 256),  # b3_d256_g16_bf16
    (4, 8192, 256),  # b3_gemma2_serial_bf16
    (32, 8192, 256),  # b3_gemma2_batch_bf16
]


def check_plan(pairs, cap, d):
    C, stages = da.cluster_plan(pairs, cap, d)
    assert (C, stages) == ref.cluster_plan(pairs, cap, d), (pairs, cap, d)
    blocks = -(-cap // 64)
    assert C in (1, 2, 4, 8, 16) and C <= da.CLUSTER_MAX
    assert C == 1 or (pairs <= da.CLUSTERS_HELD[C] and C <= blocks)  # every cluster at once
    # a ring of 2 or 4 blocks, half for each group of warps, no deeper than
    # a CTA's share at capacity needs
    assert stages in (2, 4) and stages // 2 <= -(-blocks // (2 * C))
    # the ring fits the shared memory a CTA may have, beside Q (d 256) and
    # the peers' partials at the widest group (the kernel's cl_smem_bytes)
    peers = 16 * C * -(-(16 * d // 4) // C) + 8 * C * 16
    assert (stages * da.cluster_stage_bytes(d) + (16 * (d + 8) * 2 if d > 128 else 0) + peers
            <= 232448)
    return C, stages


def test_plan_of_the_chip_shapes():
    for pairs, cap, d in CHIP_SHAPES:
        check_plan(pairs, cap, d)
    assert da.cluster_plan(8, 8192, 128) == (8, 4)  # the serial decode: 64 CTAs
    assert da.cluster_plan(4, 8192, 256) == (16, 2)  # gemma2's serial decode: 64 CTAs


@pytest.mark.parametrize("cap", CAPS)
def test_plan_sweep(cap):
    for pairs in range(1, 4097):
        for d in da.HEAD_DIMS:
            C, _ = check_plan(pairs, cap, d)
            if 2 * C <= min(16, -(-cap // 64)) and pairs <= da.CLUSTERS_HELD[2 * C]:
                pytest.fail(f"C={C} could double at pairs={pairs}, cap={cap}")


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_shares_cover_the_live_keys(cluster):
    for cap in (64, 600, 4096):
        for length in list(range(0, 300)) + [cap - 1, cap, cap + 5]:
            for window in (None, 1, 37, 64, 100, 1000):
                shares = ref.cluster_shares(length, cap, cluster, window)
                k_hi = min(length, cap)
                k_lo = 0 if window is None else max(0, length - window)
                assert len(shares) == cluster
                covered = [k for lo, hi in shares for k in range(lo, hi)]
                assert covered == list(range(k_lo, max(k_lo, k_hi)))
                sizes = [hi - lo for lo, hi in shares]
                for r, n in enumerate(sizes):
                    if any(sizes[r + 1:]):  # a later share holds keys
                        assert n == sizes[0] and n % 64 == 0 and n >= 64


def decode_case(seed, lengths, KV, G, d, S, *, dead_fill=np.nan, q_scale=1.0, window=None):
    """Rows over a (B, S, KV, d) cache whose keys at or past each length,
    and left of its window, hold ``dead_fill`` in K and V."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    q = (q_scale * rng.standard_normal((B, KV, G, d))).astype(np.float32)
    k = rng.standard_normal((B, S, KV, d)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, d)).astype(np.float32)
    for b, n in enumerate(lengths):
        k[b, n:], v[b, n:] = dead_fill, dead_fill
        if window is not None:
            k[b, :max(0, n - window)], v[b, :max(0, n - window)] = dead_fill, dead_fill
    return q, k, v, np.asarray(lengths, np.int32)


# (name, lengths, KV, G, d, S, window, softcap, q_scale, C); C None: the plan's
CASES = [
    # k_lo = 150, 51, 0: the window's left edge inside a block
    ("window_mid_block", [300, 201, 77], 2, 4, 16, 320, 150, None, 1.0, 4),
    # C 16 over rows of 1 to 65 keys: most ranks empty
    ("empty_shares_and_one_key", [1, 5, 64, 65], 2, 2, 16, 128, None, None, 1.0, 16),
    # 256 keys over 4 ranks: one block each, the last share ending at the cap
    ("exact_c64", [256, 255], 1, 2, 16, 256, None, None, 1.0, 4),
    ("softcap50_g16_d128", [200, 317], 1, 16, 128, 320, None, 50.0, 8.0, 8),
    ("g1_d256_window", [33, 160], 2, 1, 256, 160, 100, None, 1.0, 4),
    ("g2_d128_window_softcap", [300, 100, 1], 2, 2, 128, 320, 64, 50.0, 8.0, 16),
    ("plan_g4_d16", [250, 90], 2, 4, 16, 320, None, 3.0, 1.0, None),
]
IDS = [c[0] for c in CASES]


def run_case(case, dead_fill=np.nan):
    name, lengths, KV, G, d, S, window, softcap, q_scale, C = case
    q, k, v, lens = decode_case(len(name), lengths, KV, G, d, S, dead_fill=dead_fill,
                                q_scale=q_scale, window=window)
    if C is None:
        C, _ = da.cluster_plan(len(lengths) * KV, S, d)
    t = torch.from_numpy
    args = (t(q), t(k), t(v), t(lens))
    kw = dict(window=window, softcap=softcap)
    return (q, k, v, lens), args, kw, C


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cluster_ref_matches_plain_and_jax(case):
    """NaN in every dead key and value, the tail block's included: a share
    that read one would show it."""
    (q, k, v, lens), args, kw, C = run_case(case)
    got = ref.decode_cluster_ref(*args, cluster=C, **kw)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref.decode_attention_ref(*args, **kw).numpy(), **TOL)
    # the JAX oracle multiplies dead keys by 0, so it needs finite garbage there
    B, KV, G, d = q.shape
    kz, vz = np.nan_to_num(k, nan=999.0), np.nan_to_num(v, nan=-999.0)
    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)  # noqa: E731
    oracle = jax_ref.decode_attention_ref(jnp.asarray(q), tr(kz), tr(vz), jnp.asarray(lens),
                                          **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cluster_ref_matches_pallas_interpret(case):
    """The Pallas kernel reads dead keys and relies on finite garbage there,
    so the dead fill is finite here."""
    (q, k, v, lens), args, kw, C = run_case(case, dead_fill=999.0)
    got = ref.decode_cluster_ref(*args, cluster=C, **kw)
    B, KV, G, d = q.shape
    pallas = ops.decode_attention_bhd(jnp.asarray(q.reshape(B, 1, KV * G, d)), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(lens), interpret=True,
                                      block_k=16, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas).reshape(B, KV, G, d), **TOL)


@pytest.mark.parametrize("fault", ref.B3_FAULTS)
def test_broken_combines_break_the_result(fault):
    """A combine that drops one share's rescale, or one rank's partial, must
    move the result far past the tolerance: 4 ranks over rows of 256 keys."""
    case = ("broken", [256, 250, 200], 2, 4, 16, 256, None, None, 2.0, 4)
    _, args, kw, C = run_case(case)
    plain = ref.decode_attention_ref(*args, **kw).numpy()
    broken = ref.decode_cluster_ref(*args, cluster=C, fault=fault, **kw).numpy()
    assert np.abs(broken - plain).max() > 100 * (TOL["atol"] + TOL["rtol"] * np.abs(plain).max())
    with pytest.raises(ValueError):
        ref.decode_cluster_ref(*args, cluster=C, fault="no_such_fault", **kw)


def test_bf16_cpu_call_runs_the_plain_version_and_counts_no_launch():
    (q, k, v, lens), args, kw, _ = run_case(CASES[0])
    before = da.decode_attention.launches
    bf = [a.to(torch.bfloat16) for a in args[:3]]
    got = da.decode_attention(*bf, args[3], **kw)
    assert got.dtype == torch.bfloat16 and da.decode_attention.launches == before
    np.testing.assert_array_equal(
        got.float().numpy(), ref.decode_attention_ref(*bf, args[3], **kw).float().numpy())
