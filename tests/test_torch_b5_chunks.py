"""B5's chunk-parallel decomposition, on the CPU.

The plain mirror of the kernel's algebra (``ref.ssd_chunk_parallel_ref``:
each chunk's own part -- intra-chunk y, decay d_c and state contribution
S_c -- without the carried state, the chunk-end states folded in the
kernel's order, y completed from the chunk-start states) against
``ref.ssd_chunk_ref`` and against the JAX package's Pallas ``ops.ssd`` in
interpret mode, at the shapes of ``test_torch_kernels.py``'s SSD cases and
with Mamba2-2.7B's decay rates; the affine maps' composition in the
look-back's order; the Python copy of the kernel's schedule
(``ref.ssd_chunk_schedule``: the ticket order and the ring bound, which
``chip_smoke.py`` holds the card's to) for every S of 1..4096, with the
carry protocol run under many interleavings of the CTAs; and the broken
carries ``chip_smoke.py`` must reject, each told apart from the right
answer. Inputs from fixed numpy seeds; fp32 throughout; rtol = atol = 2e-5
against the chunked versions (the sums run in other orders) and 1e-4
against the sequential recurrence.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
M2 = dict(nh=80, hd=64, G=1, ds=128)  # Mamba2-2.7B's SSD widths

# (B, S, nh, hd, G, ds, h0): one chunk, ragged, several chunks, two groups
# (test_torch_kernels.py's SSD_CASES)
SSD_CASES = [
    (1, 64, 4, 16, 1, 16, False),
    (1, 100, 4, 16, 1, 16, True),
    (2, 200, 8, 8, 2, 16, True),
    (2, 77, 16, 8, 1, 16, False),
    (1, 300, 4, 32, 1, 32, True),
]


def ssd_inputs(seed, B, S, nh, hd, G, ds, *, h0=True, mamba_decay=False):
    """numpy inputs of one SSD call. ``mamba_decay``: Mamba2-2.7B's decay
    rates A = -(1..nh) with dt = 0.1, the top of its init range."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    if mamba_decay:
        A = -np.arange(1, nh + 1, dtype=np.float32)
        dt = np.full((B, S, nh), 0.1, np.float32)
    else:
        A = -np.exp(0.3 * rng.standard_normal(nh)).astype(np.float32)
        dt = np.log1p(np.exp(rng.standard_normal((B, S, nh)))).astype(np.float32)
    Bm = (0.5 * rng.standard_normal((B, S, G, ds))).astype(np.float32)
    Cm = (0.5 * rng.standard_normal((B, S, G, ds))).astype(np.float32)
    h = rng.standard_normal((B, nh, hd, ds)).astype(np.float32) if h0 else None
    return x, dt, A, Bm, Cm, h


def _torch(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _jax(arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("B,S,nh,hd,G,ds,h0", SSD_CASES)
def test_chunk_parallel_matches_plain_and_pallas_interpret(B, S, nh, hd, G, ds, h0):
    args = ssd_inputs(3 * S + nh, B, S, nh, hd, G, ds, h0=h0)
    y, hT = ref.ssd_chunk_parallel_ref(*_torch(args))
    py, ph = ref.ssd_chunk_ref(*_torch(args))
    np.testing.assert_allclose(y.numpy(), py.numpy(), **TOL)
    np.testing.assert_allclose(hT.numpy(), ph.numpy(), **TOL)
    *xs, h = _jax(args)
    jy, jh = ops.ssd(*xs, h0=h, chunk=64, interpret=True)
    assert y.shape == (B, S, nh, hd) and hT.shape == (B, nh, hd, ds)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(jh), **TOL)


@pytest.mark.parametrize("S", [64, 130, 200])
def test_chunk_parallel_with_mamba2_decay_rates(S):
    """Mamba2-2.7B's 80 decay rates with dt = 0.1: the strongest head's
    chunk decay d_c underflows toward 0 and the masked triangle's exponent
    would overflow; the mirror stays finite and equals the sequential
    recurrence and the Pallas kernel."""
    args = ssd_inputs(S, 1, S, 80, 4, 1, 8, mamba_decay=True)
    y, hT = ref.ssd_chunk_parallel_ref(*_torch(args))
    assert np.isfinite(y.numpy()).all() and np.isfinite(hT.numpy()).all()
    sy, sh = jax_ref.ssd_ref(*_jax(args[:5]), h0=_jax(args[5:])[0])
    np.testing.assert_allclose(y.numpy(), np.asarray(sy), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(hT.numpy(), np.asarray(sh), rtol=1e-4, atol=1e-4)
    *xs, h = _jax(args)
    jy, jh = ops.ssd(*xs, h0=h, chunk=64, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(jh), **TOL)


def _chunk_maps(args):
    """Each chunk's affine map h -> d_c h + S_c, from the mirror run on the
    chunk alone with h0 = 0 (S_c) and the chunk's cumulative decay (d_c)."""
    x, dt, A, Bm, Cm, _ = _torch(args)
    L = ref.SSD_CHUNK
    maps = []
    for t in range(0, x.shape[1], L):
        sl = slice(t, t + L)
        S_c = ref.ssd_chunk_parallel_ref(x[:, sl], dt[:, sl], A, Bm[:, sl], Cm[:, sl])[1]
        d_c = torch.exp((dt[:, sl] * A).sum(dim=1))
        maps.append((d_c, S_c))
    return maps


@pytest.mark.parametrize("seed,B,S,nh,hd,G,ds", [(0, 1, 300, 4, 8, 1, 16),
                                                  (1, 2, 450, 8, 16, 2, 8)])
def test_composed_chunk_maps_give_every_chunk_end_state(seed, B, S, nh, hd, G, ds):
    """Folding the chunks' maps (d_c, S_c) by (d_b d_a, d_b S_a + S_b) --
    from the nearest predecessor backwards, as a decoupled look-back would,
    or forwards, as the kernel carries them -- gives each chunk-end state of
    the plain scan on the prefix."""
    args = ssd_inputs(seed, B, S, nh, hd, G, ds, h0=True)
    maps = _chunk_maps(args)
    h0 = torch.from_numpy(args[5])
    forward = None
    for c in range(len(maps)):
        forward = maps[c] if forward is None else ref.ssd_compose(forward, maps[c])
        back = maps[c]
        for p in range(c - 1, -1, -1):  # look back: prepend the predecessors
            back = ref.ssd_compose(maps[p], back)
        end = (c + 1) * ref.SSD_CHUNK
        prefix = [a[:, :end] if a.ndim > 1 and a.shape[1] == S else a for a in args[:5]]
        want = ref.ssd_chunk_ref(*_torch(prefix), h0)[1].numpy()
        for d, Sx in (forward, back):
            got = d[..., None, None] * h0 + Sx
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the schedule: ticket order and ring
# ---------------------------------------------------------------------------

SHAPES = [dict(B=1, **M2), dict(B=2, **M2), dict(B=1, nh=8, hd=32, G=2, ds=32),
          dict(B=2, nh=16, hd=8, G=1, ds=16), dict(B=1, nh=3, hd=128, G=3, ds=64)]


def _sched(shape, S, bf16, sms=132):
    return ref.ssd_chunk_schedule(shape["B"], S, shape["nh"], shape["hd"], shape["G"],
                                  shape["ds"], bf16=bf16, sms=sms)


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s.values())))
def test_schedule_covers_every_item_once_in_chunk_major_order(shape, bf16):
    """For every S of 1..4096: the grid is at least one CTA and at most the
    items or CTAs an SM times the SMs; the items a chunk cover every (batch,
    head, hd column) once; each item's predecessor (the same head and
    columns, one chunk back) has a smaller ticket; the ring reuses a slot
    only with at least two slots, and the scratch holds its flags and
    states. At Mamba2-2.7B's widths (one sequence) the ring stays within
    half the H100's 50 MB L2."""
    nh, hd = shape["nh"], shape["hd"]
    for S in range(1, 4097):
        s = _sched(shape, S, bf16)
        assert s["nc"] == -(-S // ref.SSD_CHUNK)
        assert 1 <= s["grid"] <= min(s["n_items"], ref.SSD_CTAS_PER_SM * 132)
        assert s["ring"] == 0 if s["nc"] == 1 else 1 <= s["ring"] <= s["nc"] - 1
        assert s["ring"] >= 2 or s["ring"] == s["nc"] - 1  # a reused slot has a successor
        slots = s["ring"] * s["ipc"]
        ring_bytes = 4 * slots * s["hs"] * ref.SSD_DS_MAX
        assert s["nbytes"] >= 16 + 8 * slots * (ref.SSD_WARPS + 1) + ring_bytes
        if shape == SHAPES[0] and bf16:
            assert ring_bytes <= 25 * 2**20
    s = _sched(shape, 4096, bf16)
    seen = set()
    for t in range(s["ipc"]):
        c, b, h, d0 = ref.ssd_item(t, s, nh)
        assert c == 0
        for d in range(d0, min(d0 + s["hs"], hd)):
            seen.add((b, h, d))
    assert seen == {(b, h, d) for b in range(shape["B"]) for h in range(nh) for d in range(hd)}
    for t in range(s["ipc"], s["n_items"], 97):
        c, *rest = ref.ssd_item(t, s, nh)
        assert ref.ssd_item(t - s["ipc"], s, nh) == (c - 1, *rest)


EPOCH_WRAP = 2**32  # the flags hold 32 bits of the epoch


def simulate_carry(s, seed, *, calls=2, word=1, epoch_from="scratch"):
    """The kernel's carry protocol under one random interleaving of its
    CTAs, over ``calls`` calls on one scratch. Each CTA reads the call's
    epoch from the scratch's epoch word as it starts, holds the ticket it
    works on and the next one it took, does its item's carry-free part, then
    waits until the flag of chunk c-1 reads (epoch, c-1) (``ready``) and the
    slot it writes has been read by its previous tenant's successor
    (``consumed``), reads its start state, writes its end state and sets
    both flags; after its last item it counts itself finished, and the last
    CTA to finish moves the word on, to 1 past 2^32 - 1 after zeroing every
    flag and slot. The ring's slots and the flags also record the call that
    wrote them (which the kernel cannot see): every read must find this
    call's chunk c-1 there, and every call must end. ``epoch_from="argument"``
    is the protocol before the word: an epoch fixed per launch, as a
    replayed CUDA graph would repeat it. Returns the epochs the calls ran
    at."""
    rng = np.random.default_rng(seed)
    nc, ipc, ring = s["nc"], s["ipc"], s["ring"]
    slot = {}  # (slot, item) -> (call, chunk) whose end state it holds
    ready, consumed = {}, {}  # (slot, item) -> (epoch, chunk, call)
    epochs = []
    for call in range(calls):
        ticket, done, finished = 0, 0, 0
        epoch = word if epoch_from == "scratch" else 1
        epochs.append(epoch)

        def take():
            nonlocal ticket
            ticket += 1
            return ticket - 1 if ticket <= s["n_items"] else None

        def flag_reads(flags, c, u, want):
            """Whether the flag of chunk c's slot reads (epoch, want), and if
            so, that this call set it."""
            val = flags.get((c % ring, u))
            if val is None or val[:2] != (epoch, want):
                return False
            assert val[2] == call, f"call {call} took call {val[2]}'s flag for chunk {want}"
            return True

        ctas = [[take(), "free", None] for _ in range(s["grid"])]  # [ticket, phase, next]
        while finished < s["grid"]:
            runnable = []
            for i, (t, phase, _) in enumerate(ctas):
                if phase == "finished":
                    continue
                if t is not None and phase == "wait":
                    c, u = divmod(t, ipc)
                    if not ((c == 0 or flag_reads(ready, c - 1, u, c - 1)) and (
                            c == nc - 1 or c < ring or flag_reads(consumed, c, u, c - ring))):
                        continue
                runnable.append(i)
            assert runnable, f"no CTA can move: {ctas}"
            i = int(rng.choice(runnable))
            t, phase, _ = ctas[i]
            if t is None:  # no item left: count itself finished
                ctas[i][1] = "finished"
                finished += 1
                continue
            c, u = divmod(t, ipc)
            if phase == "free":  # take the next ticket; the part that needs no carried state
                ctas[i] = [t, "wait", take()]
                continue
            if c > 0:  # read chunk c - 1's end state
                assert slot[((c - 1) % ring, u)] == (call, c - 1)
            if c < nc - 1:
                key = (c % ring, u)
                assert key not in slot or slot[key][0] != call or \
                    consumed.get(key, ())[:2] == (epoch, slot[key][1])
                slot[key] = (call, c)
                ready[key] = (epoch, c, call)
            if c > 0:
                consumed[((c - 1) % ring, u)] = (epoch, c - 1, call)
            ctas[i] = [ctas[i][2], "free", None]
            done += 1
        assert done == s["n_items"]
        if epoch_from == "scratch":  # the last CTA to finish
            word = epoch + 1
            if word == EPOCH_WRAP:
                slot.clear()
                ready.clear()
                consumed.clear()
                word = 1
    return epochs


@pytest.mark.parametrize("S,B,bf16,sms", [
    (512, 1, True, 132), (4096, 1, True, 132), (100, 1, True, 132), (4096, 1, False, 132),
    (1000, 2, True, 132), (64, 1, True, 132), (65, 1, False, 132),
    # a small card or a big batch: grids of a few CTAs and a ring of 2-3 slots
    (4096, 1, True, 3), (777, 2, False, 1), (4096, 4, True, 8), (300, 1, True, 1)])
def test_carry_protocol_ends_and_never_reads_an_overwritten_slot(S, B, bf16, sms):
    s = ref.ssd_chunk_schedule(B, S, 80, 64, 1, 128, bf16=bf16, sms=sms)
    if s["nc"] > s["ring"] + 1:
        assert s["ring"] >= 2
    for seed in range(3 if s["n_items"] <= 6000 else 1):  # interleavings
        simulate_carry(s, seed)


@pytest.mark.parametrize("S,B,bf16,sms", [(512, 1, True, 132), (200, 1, True, 132)])
def test_an_epoch_fixed_per_launch_takes_a_replayed_calls_flags(S, B, bf16, sms):
    """The protocol before the epoch word, an epoch passed with the launch,
    under a second call with the same epoch (a replayed CUDA graph): some
    interleaving lets a wait take the first call's flag and read its state.
    With the epoch read from the scratch, the same interleavings are safe."""
    s = ref.ssd_chunk_schedule(B, S, 80, 64, 1, 128, bf16=bf16, sms=sms)
    caught = 0
    for seed in range(4):
        simulate_carry(s, seed)
        try:
            simulate_carry(s, seed, epoch_from="argument")
        except AssertionError:
            caught += 1
    assert caught > 0


def test_epoch_word_wraps_to_one():
    """From 2^32 - 1 the last CTA zeroes the flags and the slots and sets the
    word to 1: the next calls run at epochs 1 and 2 and read only their own
    states."""
    s = ref.ssd_chunk_schedule(1, 600, 80, 64, 1, 128, bf16=True, sms=4)
    assert s["ring"] >= 2 and s["nc"] > s["ring"] + 1  # slots are reused
    assert simulate_carry(s, 0, calls=3, word=EPOCH_WRAP - 1) == [EPOCH_WRAP - 1, 1, 2]


# ---------------------------------------------------------------------------
# the broken carries chip_smoke.py must reject
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fault", ref.SSD_FAULTS)
@pytest.mark.parametrize("B,S,nh,hd,G,ds,h0,mamba", [
    (1, 100, 4, 16, 1, 16, True, False), (2, 200, 8, 8, 2, 16, True, False),
    (1, 300, 4, 32, 1, 32, True, False), (1, 130, 80, 4, 1, 8, True, True),
    (1, 200, 80, 4, 1, 8, False, True)])
def test_each_fault_differs_from_the_right_answer(B, S, nh, hd, G, ds, h0, mamba, fault):
    """A carry without the chunk's decay, or one that hands chunk c chunk
    c-2's end state, moves y well past the kernel's fp32 tolerance (1e-4 of
    1 + |y|) wherever there are two chunks or more."""
    args = _torch(ssd_inputs(11 * S + nh, B, S, nh, hd, G, ds, h0=h0, mamba_decay=mamba))
    y, hT = ref.ssd_chunk_parallel_ref(*args)
    fy, fh = ref.ssd_chunk_parallel_ref(*args, fault=fault)
    used = ((fy - y).abs() / (1e-4 * (1 + y.abs()))).max()
    assert used > 100


def test_faults_are_named_and_checked():
    args = _torch(ssd_inputs(0, 1, 64, 2, 8, 1, 8))
    with pytest.raises(ValueError):
        ref.ssd_chunk_parallel_ref(*args, fault="no_decay")
    # one chunk: there is no carry to break but h0's decay
    y, hT = ref.ssd_chunk_parallel_ref(*args)
    sy, sh = ref.ssd_chunk_parallel_ref(*args, fault="stale_state")
    assert torch.equal(sy, y) and torch.equal(sh, hT)
