"""Plain PyTorch versions of the port's kernels: attention (B1-B4) and the
Mamba2 SSD chunk scan (B5).

They compute what the JAX package's ``kernels/ref.py`` oracles compute, in
fp32, and are what the kernel wrappers run on CPU tensors. Unlike the JAX
oracles they never let a dead key touch the result: keys at or after a
row's length (or below its window) are zeroed before the products, so
NaN-filled dead and scratch pages give the same answer as clean ones (the
JAX oracle relies on finite garbage: ``0 * NaN`` is NaN).

Layouts are the port's kernels', which read the model's tensors in place:
``flash_attention_ref`` takes ``(B, S, H, d)`` queries and ``(B, S, KV, d)``
keys (the JAX oracle ``(B, H, S, d)`` and ``(B, KV, S, d)``), and
``decode_attention_ref`` a ``(B, S, KV, d)`` cache (JAX ``(B, KV, S, d)``).

``ssd_chunk_ref`` is B5's plain version: the JAX package's model-side
``ssd_chunked`` in the layout the kernel reads (model layout, ragged ``S``
zero-padded to its chunk, fp32 throughout, ``y`` cast to ``x``'s dtype);
``ssd_ref`` is the sequential recurrence both are held to.

Each function's ``cuda_calls`` counts its calls on CUDA tensors, so a run
can show that its main path never fell back to a plain version.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1.0e30
SSD_CHUNK = 64  # tokens per chunk of B5 (its kernel's chunk)


def _softcap(s: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    return s if cap is None else cap * torch.tanh(s / cap)


def _zero_dead(kc, vc, live):
    """Zero the keys/values outside ``live`` (broadcast over the trailing
    KV and d axes), so NaN garbage in dead slots never reaches a product."""
    live = live[..., None, None]
    return torch.where(live, kc, 0.0), torch.where(live, vc, 0.0)


def _counts_cuda_calls(fn):
    """Give ``fn`` a ``cuda_calls`` counter of its calls on CUDA tensors."""
    @functools.wraps(fn)
    def counted(q, *args, **kwargs):
        if q.is_cuda:
            counted.cuda_calls += 1
        return fn(q, *args, **kwargs)

    counted.cuda_calls = 0
    return counted


def _attend(q, kc, vc, ok, softcap):
    """q (..., KV, G, d) fp32 queries over keys kc/vc (..., S, KV, d) fp32
    whose dead entries are already zeroed; ``ok`` (..., S) marks the keys
    each query row may read (its leading axes broadcast against q's)."""
    d = q.shape[-1]
    s = torch.einsum("...kgd,...skd->...kgs", q, kc) / d**0.5
    s = _softcap(s, softcap)
    s = torch.where(ok[..., None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("...kgs,...skd->...kgd", p, vc)


def _one_query_rows(q, kc, vc, lengths, window, softcap):
    """q (N,KV,G,d): one query per row at position ``lengths[n] - 1`` over
    that row's keys kc/vc (N,S,KV,d); keys at or past the length, or left of
    the window, are zeroed before the products."""
    S = kc.shape[1]
    lengths = lengths.long()[:, None]
    k_pos = torch.arange(S, device=q.device)[None, :]
    ok = k_pos < lengths
    if window is not None:
        ok &= k_pos > (lengths - 1) - window
    kc, vc = _zero_dead(kc.float(), vc.float(), ok)
    return _attend(q.float(), kc, vc, ok, softcap).to(q.dtype)


@_counts_cuda_calls
def flash_attention_ref(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None):
    """q: (B,Sq,H,d); k/v: (B,Sk,KV,d) -> (B,Sq,H,d). Query i sits at
    position i; with ``causal`` it attends keys j <= i, and with ``window``
    only j > i - window. Keys no query may read (j >= Sq under ``causal``)
    are zeroed before the products."""
    B, Sq, H, d = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos <= q_pos
    if window is not None:
        ok &= k_pos > q_pos - window
    kc, vc = _zero_dead(k.float(), v.float(), ok.any(0))
    # query positions ride as a leading axis of _attend's (..., KV, G, d)
    qg = q.float().reshape(B, Sq, KV, H // KV, d)
    o = _attend(qg, kc[:, None], vc[:, None], ok[None], softcap)  # (B,Sq,KV,G,d)
    return o.reshape(B, Sq, H, d).to(q.dtype)


@_counts_cuda_calls
def decode_attention_ref(q, k, v, lengths, *, window: Optional[int] = None,
                         softcap: Optional[float] = None):
    """q: (B,KV,G,d); k/v: (B,S,KV,d) dense cache; lengths (B,) ->
    (B,KV,G,d). Row b's one query sits at position ``lengths[b] - 1``."""
    return _one_query_rows(q, k, v, lengths, window, softcap)


@_counts_cuda_calls
def paged_attention_ref(q, k_pages, v_pages, lengths, block_tables, *,
                        window: Optional[int] = None, softcap: Optional[float] = None):
    """q: (N,KV,G,d); k/v_pages: (P,page,KV,d); lengths (N,);
    block_tables (N,nb) -> (N,KV,G,d).

    Row n holds one query at position ``lengths[n] - 1`` and reads its pages
    in block-table order (logical key position ``ib*page + offset``)."""
    N, KV, G, d = q.shape
    S = block_tables.shape[1] * k_pages.shape[1]
    tabs = block_tables.long()
    return _one_query_rows(q, k_pages[tabs].reshape(N, S, KV, d),
                           v_pages[tabs].reshape(N, S, KV, d), lengths, window, softcap)


@_counts_cuda_calls
def mixed_attention_ref(q, k_pages, v_pages, cu_q_lens, kv_lens, block_tables, *,
                        window: Optional[int] = None, softcap: Optional[float] = None):
    """Mixed-batch (prefill chunks + decode rows) attention, one segment at a
    time.

    q: (N,KV,G,d) flat packed rows; cu_q_lens: (S+1,) row offsets of each
    segment; kv_lens: (S,) keys the segment's *last* row attends;
    block_tables: (S,nb) per-segment page ids. Row j of segment s sits at
    position ``kv_lens[s] - q_len + j`` and attends the keys at or before it
    (and, with ``window``, above ``position - window``). Zero-width segments
    are skipped; rows at or after ``cu_q_lens[-1]`` are padding and come
    back zero.
    """
    N, KV, G, d = q.shape
    page = k_pages.shape[1]
    out = torch.zeros((N, KV, G, d), dtype=torch.float32, device=q.device)
    cu = cu_q_lens.tolist()
    kvl = kv_lens.tolist()
    for s, kv_len in enumerate(kvl):
        r0, r1 = cu[s], cu[s + 1]
        q_len = r1 - r0
        if q_len == 0:
            continue
        n_pages = -(-kv_len // page)
        tabs = block_tables[s, :n_pages].long()
        kc = k_pages[tabs].reshape(n_pages * page, KV, d).float()
        vc = v_pages[tabs].reshape(n_pages * page, KV, d).float()
        q_pos = torch.arange(kv_len - q_len, kv_len, device=q.device)[:, None]
        k_pos = torch.arange(n_pages * page, device=q.device)[None, :]
        ok = k_pos <= q_pos  # (q_len, keys); also keeps k_pos < kv_len
        live = k_pos[0] < kv_len  # keys any row of the segment may read
        if window is not None:
            ok &= k_pos > q_pos - window
            live &= k_pos[0] > kv_len - q_len - window
        kc, vc = _zero_dead(kc, vc, live)
        out[r0:r1] = _attend(q[r0:r1].float(), kc[None], vc[None], ok, softcap)
    return out.to(q.dtype)


def mixed_split_ref(q, k_pages, v_pages, cu_q_lens, kv_lens, block_tables, *, cta_rows: int,
                    span_keys: int, window: Optional[int] = None,
                    softcap: Optional[float] = None, rescale: bool = True):
    """``mixed_attention_ref`` computed as B1's kernel splits it: each
    segment's rows in groups of ``cta_rows`` (one CTA's rows), each group's
    keys (from the window's left edge of its first row to its last row's
    position) cut into spans of ``span_keys * rows`` keys, each span's
    partial (O, m, l) taken alone, then combined:
    O = sum_s e^(m_s - M) O_s / sum_s e^(m_s - M) l_s with M = max_s m_s.
    ``rescale=False`` sums the partials without the e^(m_s - M) weights,
    the fault a combine must not have. Same arguments and result as
    ``mixed_attention_ref``."""
    N, KV, G, d = q.shape
    page = k_pages.shape[1]
    out = torch.zeros((N, KV, G, d), dtype=torch.float32, device=q.device)
    cu = cu_q_lens.tolist()
    for s, kv_len in enumerate(kv_lens.tolist()):
        r0, r1 = cu[s], cu[s + 1]
        q_len = r1 - r0
        if q_len == 0:
            continue
        n_pages = -(-kv_len // page)
        tabs = block_tables[s, :n_pages].long()
        kc = k_pages[tabs].reshape(n_pages * page, KV, d)[:kv_len].float()
        vc = v_pages[tabs].reshape(n_pages * page, KV, d)[:kv_len].float()
        for c0 in range(r0, r1, cta_rows):
            nrow = min(cta_rows, r1 - c0)
            pos0 = kv_len - q_len + (c0 - r0)
            k_lo = 0 if window is None else max(0, pos0 - window + 1)
            span = span_keys * nrow
            q_pos = torch.arange(pos0, pos0 + nrow, device=q.device)[:, None]
            qc = q[c0:c0 + nrow].float()
            os_, ms, ls = [], [], []
            for lo in range(k_lo, pos0 + nrow, span):
                hi = min(pos0 + nrow, lo + span)
                k_pos = torch.arange(lo, hi, device=q.device)[None, :]
                ok = k_pos <= q_pos
                if window is not None:
                    ok &= k_pos > q_pos - window
                sc = _softcap(torch.einsum("rkgd,skd->rkgs", qc, kc[lo:hi]) / d**0.5, softcap)
                sc = torch.where(ok[:, None, None, :], sc, -torch.inf)
                m = sc.amax(-1).clamp_min(NEG_INF)  # a row with no key here: NEG_INF
                p = torch.exp(sc - m[..., None])
                os_.append(torch.einsum("rkgs,skd->rkgd", p, vc[lo:hi]))
                ms.append(m)
                ls.append(p.sum(-1))
            o, m, l = torch.stack(os_), torch.stack(ms), torch.stack(ls)
            w = torch.exp(m - m.amax(0)) if rescale else torch.ones_like(m)
            out[c0:c0 + nrow] = ((w[..., None] * o).sum(0)
                                 / (w * l).sum(0).clamp_min(1e-37)[..., None])
    return out.to(q.dtype)


# B3's bf16 cluster, as the kernel's library sizes it (csrc/decode_attention.cu)
B3_BLOCK = 64  # keys a staged block
B3_RING_BYTES = 212992  # a CTA's ring of K/V blocks
B3_HELD = {16: 7, 8: 15, 4: 30, 2: 66, 1: 132}  # an H100's clusters at once, by size
B3_STAGES_MAX = 4
B3_FAULTS = ("no_rescale", "lost_share")


def cluster_plan(pairs, cap, head_dim):
    """Python copy of ``decode_attention.cluster_plan``, used by tests and
    ``chip_smoke.py``: (C, stages) for ``pairs`` (row, KV head) pairs over a
    cache of ``cap`` keys a row at head dim ``head_dim``. C is the widest of
    the cluster sizes 16, 8, 4, 2, 1 of which an H100 holds ``pairs`` at
    once and whose CTAs each get a block at capacity; the ring holds 2 or 4
    blocks (two groups of warps, a half each): 4 where a CTA's share at
    capacity needs them and its bytes allow."""
    blocks = max(1, -(-cap // B3_BLOCK))
    C = next(c for c in (16, 8, 4, 2, 1) if c == 1 or (pairs <= B3_HELD[c] and c <= blocks))
    stage = 2 * B3_BLOCK * (head_dim + 8) * 2  # K and V rows of a block, bf16, padded by 8
    a_group = min(B3_RING_BYTES // (2 * stage), B3_STAGES_MAX // 2, -(-blocks // (2 * C)))
    return C, 2 * a_group


def cluster_shares(length, cap, cluster, window=None):
    """The keys [lo, hi) each CTA rank of a B3 cluster takes of a row of
    ``length`` over a cache of ``cap`` keys: the live keys [max(0, length -
    window), min(length, cap)) cut into ``cluster`` spans of ceil(live / C)
    rounded up to a block; trailing ranks may get none (lo == hi)."""
    k_hi = min(length, cap)
    k_lo = 0 if window is None else max(0, length - window)
    live = max(0, k_hi - k_lo)
    span = -(-(-(-live // cluster)) // B3_BLOCK) * B3_BLOCK
    out = []
    for r in range(cluster):
        lo = k_lo + r * span
        out.append((lo, max(lo, min(k_hi, lo + span))))
    return out


def decode_cluster_ref(q, k, v, lengths, *, cluster: int, window: Optional[int] = None,
                       softcap: Optional[float] = None, fault: Optional[str] = None):
    """``decode_attention_ref`` computed as B3's bf16 kernel splits it, used
    by tests and ``chip_smoke.py``: each row's live keys cut into the
    ``cluster`` CTA shares of ``cluster_shares``, each share's partial (m, l,
    acc) taken alone (m = NEG_INF, l = 0, acc = 0 for an empty share), then
    combined as the rank that owns an output combines it: m = max_c m_c,
    each partial weighted by e^(m_c - m), the C weighted partials summed in
    the kernel's butterfly (partial c plus partial c ^ o, for o = 1, 2, 4,
    ...; ``cluster`` a power of two), out = acc / max(l, 1e-37). Keys
    outside a share are never read. Same arguments and result as
    ``decode_attention_ref``.

    ``fault`` names a broken combine, for checks that must reject one:
    ``"no_rescale"`` (the partials summed without e^(m_c - m)) or
    ``"lost_share"`` (rank 0's partial left out)."""
    if fault not in (None,) + B3_FAULTS:
        raise ValueError(f"fault {fault!r} is not one of {B3_FAULTS}")
    B, KV, G, d = q.shape
    S = k.shape[1]
    out = torch.zeros((B, KV, G, d), dtype=torch.float32, device=q.device)
    for b, length in enumerate(lengths.tolist()):
        qb = q[b].float()
        ms, ls, accs = [], [], []
        for lo, hi in cluster_shares(length, S, cluster, window):
            s = _softcap(torch.einsum("kgd,skd->kgs", qb, k[b, lo:hi].float()) / d**0.5, softcap)
            m = s.amax(-1) if hi > lo else torch.full((KV, G), NEG_INF, device=q.device)
            p = torch.exp(s - m[..., None])
            ms.append(m)
            ls.append(p.sum(-1))
            accs.append(torch.einsum("kgs,skd->kgd", p, v[b, lo:hi].float()))
        m_all = torch.stack(ms).amax(0)
        w = [torch.ones_like(m) if fault == "no_rescale" else torch.exp(m - m_all) for m in ms]
        if fault == "lost_share":
            w[0] = torch.zeros_like(w[0])
        l_c = [wc * lc for wc, lc in zip(w, ls)]
        a_c = [wc[..., None] * ac for wc, ac in zip(w, accs)]
        o = 1
        while o < cluster:  # the kernel's shuffles: lane c adds lane c ^ o
            l_c = [l_c[c] + l_c[c ^ o] for c in range(cluster)]
            a_c = [a_c[c] + a_c[c ^ o] for c in range(cluster)]
            o *= 2
        out[b] = a_c[0] * (1.0 / l_c[0].clamp_min(1e-37))[..., None]
    return out.to(q.dtype)


def mixed_split_plan(tiles, cu_q_lens, kv_lens, *, tile_rows: int, group: int, span_keys: int,
                     pair: bool, light_max: int, n_kv: int, sms: int,
                     window: Optional[int] = None):
    """The plain version of B1's plan pass (``plan_rows``, ``plan_spans`` and
    the plan kernel of ``csrc/mixed_paged_attention.cu``), on host lists:
    which rows each CTA takes and its keys in spans. ``tiles`` are
    ``q_tiles(cu_q_lens, group)`` of ``tile_rows`` rows; with ``pair`` a CTA
    takes two consecutive tiles of a segment (bf16). A CTA of at most 16
    query vectors takes spans of ``span_keys * rows`` keys; the heavier
    ones split only when they are fewer than ``sms / (2 n_kv)``, into spans
    of their keys' share of ``sms / n_kv`` CTAs, in blocks of 64. Returns
    (ctas, heavy_span): one dict per CTA, in tile order, with its leading
    ``tile``, ``seg``, ``row0``, ``nrow``, keys ``k_lo``..``k_hi``, query
    vectors ``m_eff``, ``kind`` (0: light, at most ``light_max`` vectors;
    1: heavy), ``step`` (keys per span) and ``spans`` [(lo, hi)]."""
    cu = [int(x) for x in cu_q_lens]
    ctas = []
    for t, (seg, row0) in enumerate(tiles):
        seg, row0 = int(seg), int(row0)
        lo, hi = cu[seg], cu[seg + 1]
        odd = ((row0 - lo) // tile_rows) % 2 if pair else 0
        if odd:
            continue
        nrow = min(2 * tile_rows if pair else tile_rows, hi - row0)
        pos0 = int(kv_lens[seg]) - (hi - lo) + (row0 - lo)
        k_lo = 0 if window is None else max(0, pos0 - window + 1)
        ctas.append(dict(tile=t, seg=seg, row0=row0, nrow=nrow, k_lo=k_lo, k_hi=pos0 + nrow,
                         m_eff=nrow * group, kind=int(nrow * group > light_max)))
    heavy = [c for c in ctas if c["m_eff"] > 16]
    share = -(-sum(c["k_hi"] - c["k_lo"] for c in heavy) * n_kv // sms)
    heavy_span = 1 << 30 if 2 * len(heavy) * n_kv >= sms else max(span_keys, -(-share // 64) * 64)
    for c in ctas:
        c["step"] = span_keys * c["nrow"] if c["m_eff"] <= 16 else heavy_span
        c["spans"] = [(k, min(c["k_hi"], k + c["step"]))
                      for k in range(c["k_lo"], c["k_hi"], c["step"])] or [(c["k_lo"], c["k_lo"])]
    return ctas, heavy_span


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad axis 1 (the sequence) of ``t`` by ``pad`` rows, in fp32."""
    t = t.float()
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) if pad else t


@_counts_cuda_calls
def ssd_chunk_ref(x, dt, A, Bm, Cm, h0=None, *, chunk: int = SSD_CHUNK):
    """Chunked SSD scan (Mamba2's state-space duality), as ``ssd_chunked``.

    x: (B,S,nh,hd); dt: (B,S,nh) softplus'd step sizes; A: (nh,) negative
    decay rates; Bm/Cm: (B,S,G,ds), head h reading group h // (nh // G);
    h0: (B,nh,hd,ds) initial state or None (zeros). Returns y (B,S,nh,hd) in
    x's dtype and the final state hT (B,nh,hd,ds) fp32. Padding tokens have
    dt = 0, so they neither decay nor feed the state: hT is exact for any S.

    Within a chunk, y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
    + exp(cum_i) C_i . h_start; the decay is exponentiated only on and below
    the diagonal (above it cum_i - cum_j > 0 can overflow to inf, and inf *
    0 is NaN).
    """
    Bsz, S, nh, hd = x.shape
    G, ds = Bm.shape[2], Bm.shape[3]
    rep = nh // G
    L = chunk
    pad = (-S) % L
    nc = (S + pad) // L
    xf = _pad_seq(x, pad).reshape(Bsz, nc, L, nh, hd)
    dtf = _pad_seq(dt, pad).reshape(Bsz, nc, L, nh)
    Bf = _pad_seq(Bm, pad).reshape(Bsz, nc, L, G, ds)
    Cf = _pad_seq(Cm, pad).reshape(Bsz, nc, L, G, ds)
    cum = torch.cumsum(dtf * A.float(), dim=2)  # (B,nc,L,nh), within each chunk

    # intra-chunk: w[i,j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i
    CB = torch.einsum("bclgs,bcmgs->bcglm", Cf, Bf).repeat_interleave(rep, dim=2)
    ci = cum.permute(0, 1, 3, 2)  # (B,nc,nh,L)
    diff = ci[..., :, None] - ci[..., None, :]
    lower = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    dec = torch.exp(torch.where(lower, diff, float("-inf")))
    w = CB * dec * dtf.permute(0, 1, 3, 2)[..., None, :]
    y = torch.einsum("bchlm,bcmhd->bclhd", w, xf)

    # each chunk's own contribution to the state, then the recurrence
    Bh = Bf.repeat_interleave(rep, dim=3)  # (B,nc,L,nh,ds)
    Ch = Cf.repeat_interleave(rep, dim=3)
    wj = torch.exp(cum[:, :, -1:, :] - cum) * dtf  # (B,nc,L,nh)
    Sc = torch.einsum("bclh,bclhd,bclhs->bchds", wj, xf, Bh)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B,nc,nh)
    h = (torch.zeros((Bsz, nh, hd, ds), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    starts = []
    for c in range(nc):
        starts.append(h)
        h = h * chunk_decay[:, c, :, None, None] + Sc[:, c]
    h_start = torch.stack(starts, dim=1)  # (B,nc,nh,hd,ds): the state at each chunk's start

    # inter-chunk: y_i += exp(cum_i) C_i . h_start
    y = y + torch.einsum("bclhs,bchds->bclhd", Ch * torch.exp(cum)[..., None], h_start)
    return y.reshape(Bsz, nc * L, nh, hd)[:, :S].to(x.dtype), h


SSD_CTAS_PER_SM = 2  # B5's grid: at most this many CTAs an SM (its launch bounds)
SSD_WARPS = 8  # B5's warps a CTA, each carrying its own part of the state
SSD_DS_MAX = 128  # B5's widest state
SSD_FAULTS = ("no_chunk_decay", "stale_state")


def ssd_chunk_schedule(batch, seq, nh, hd, groups, ds, *, bf16, sms):
    """Python copy of B5's schedule (``schedule`` in
    ``src/repro_torch/kernels/csrc/ssd_chunk_scan.cu``), used by tests only.

    Work items are (chunk, head, ``hs`` columns of hd); ticket t is chunk
    ``t // ipc`` and item ``t % ipc`` of it (``ssd_item``), so chunk c's
    predecessor item comes ``ipc`` tickets earlier. The grid holds at most
    ``SSD_CTAS_PER_SM`` CTAs an SM. Chunk c's end state goes to ring slot
    ``c % ring`` (the last chunk's to hT); the ring is ``nc - 1`` slots when
    the chunks are few, else the chunks a full grid holds at once plus two.
    ``nbytes``: the scratch (two counters, the ready flags of each slot's
    ``SSD_WARPS`` warps, its consumed flag, its fp32 states at the widest
    state). ``groups`` and ``ds`` do not enter: an item is one head."""
    nc = -(-seq // SSD_CHUNK)
    hs = 64 if bf16 else 32
    slices = -(-hd // hs)
    ipc = batch * nh * slices
    grid = min(nc * ipc, SSD_CTAS_PER_SM * sms)
    ring = 0 if nc < 2 else min(nc - 1, max(2, -(-grid // ipc) + 2))
    slots = ring * ipc
    states = -(-(16 + 8 * slots * SSD_WARPS + 8 * slots) // 16) * 16
    return dict(grid=grid, hs=hs, ipc=ipc, ring=ring, nc=nc,
                nbytes=states + 4 * slots * hs * SSD_DS_MAX, slices=slices, n_items=nc * ipc)


def ssd_item(t, sched, nh):
    """Ticket ``t`` of a schedule: (chunk, batch, head, first hd column)."""
    c, u = divmod(t, sched["ipc"])
    rest, sl = divmod(u, sched["slices"])
    b, h = divmod(rest, nh)
    return c, b, h, sl * sched["hs"]


def ssd_compose(first, then):
    """The affine state maps h -> d h + S of two consecutive spans, first
    then ``then``, as one: (d_b d_a, d_b S_a + S_b). d: (..., nh), S: (...,
    nh, hd, ds)."""
    (da, Sa), (db, Sb) = first, then
    return db * da, db[..., None, None] * Sa + Sb


def ssd_chunk_parallel_ref(x, dt, A, Bm, Cm, h0=None, *, chunk: int = SSD_CHUNK, fault=None):
    """B5's chunk-parallel algebra done plainly, used by tests only: each
    chunk's own part -- the intra-chunk y, its decay d_c = exp(cum_L) and its
    state contribution S_c -- formed without the carried state; the chunk-end
    states folded in the order the kernel carries them, h_c = d_c h_{c-1} +
    S_c from h0 (zeros when None); then y_i += exp(cum_i) C_i . h_{c-1}.
    Same arguments and results as ``ssd_chunk_ref``.

    ``fault`` names a broken carry, for checks that must reject one:
    ``"no_chunk_decay"`` (h_c = h_{c-1} + S_c) or ``"stale_state"`` (chunk
    c starts from chunk c - 2's end state, h0 for chunks 0 and 1)."""
    if fault not in (None,) + SSD_FAULTS:
        raise ValueError(f"fault {fault!r} is not one of {SSD_FAULTS}")
    Bsz, S, nh, hd = x.shape
    G, ds = Bm.shape[2], Bm.shape[3]
    rep = nh // G
    L = chunk
    pad = (-S) % L
    nc = (S + pad) // L
    xf = _pad_seq(x, pad).reshape(Bsz, nc, L, nh, hd)
    dtf = _pad_seq(dt, pad).reshape(Bsz, nc, L, nh)
    Bh = _pad_seq(Bm, pad).reshape(Bsz, nc, L, G, ds).repeat_interleave(rep, dim=3)
    Ch = _pad_seq(Cm, pad).reshape(Bsz, nc, L, G, ds).repeat_interleave(rep, dim=3)
    cum = torch.cumsum(dtf * A.float(), dim=2)  # (B,nc,L,nh)
    lower = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    ci = cum.permute(0, 1, 3, 2)  # (B,nc,nh,L)
    dec = torch.exp(torch.where(lower, ci[..., :, None] - ci[..., None, :], float("-inf")))
    w = torch.einsum("bclhs,bcmhs->bchlm", Ch, Bh) * dec * dtf.permute(0, 1, 3, 2)[..., None, :]
    y = torch.einsum("bchlm,bcmhd->bclhd", w, xf)
    d = torch.exp(cum[:, :, -1, :])  # (B,nc,nh)
    wj = torch.exp(cum[:, :, -1:, :] - cum) * dtf
    Sc = torch.einsum("bclh,bclhd,bclhs->bchds", wj, xf, Bh)
    h = (torch.zeros((Bsz, nh, hd, ds), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ends = [h]  # ends[c + 1]: chunk c's end state; ends[0]: h0
    starts = []
    for c in range(nc):
        start = ends[max(c - 1, 0)] if fault == "stale_state" else ends[c]
        dc = torch.ones_like(d[:, c]) if fault == "no_chunk_decay" else d[:, c]
        starts.append(start)
        ends.append(dc[..., None, None] * start + Sc[:, c])
    starts = torch.stack(starts, dim=1)  # (B,nc,nh,hd,ds)
    y = y + torch.einsum("bclhs,bchds->bclhd", Ch * torch.exp(cum)[..., None], starts)
    return y.reshape(Bsz, nc * L, nh, hd)[:, :S].to(x.dtype), ends[-1]


def ssd_ref(x, dt, A, Bm, Cm, h0=None):
    """Sequential (exact) SSD recurrence oracle, one token at a time.

    x: (B,S,nh,hd), dt: (B,S,nh), A: (nh,), Bm/Cm: (B,S,G,ds), h0:
    (B,nh,hd,ds) or None. Returns y (B,S,nh,hd) in x's dtype and hT
    (B,nh,hd,ds) fp32."""
    Bsz, S, nh, hd = x.shape
    G, ds = Bm.shape[2], Bm.shape[3]
    rep = nh // G
    Bh = Bm.repeat_interleave(rep, dim=2).float()  # (B,S,nh,ds)
    Ch = Cm.repeat_interleave(rep, dim=2).float()
    xf, dtf, Af = x.float(), dt.float(), A.float()
    h = (torch.zeros((Bsz, nh, hd, ds), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        a = torch.exp(dtf[:, t] * Af)  # (B,nh)
        upd = torch.einsum("bh,bhd,bhs->bhds", dtf[:, t], xf[:, t], Bh[:, t])
        h = h * a[..., None, None] + upd
        ys.append(torch.einsum("bhds,bhs->bhd", h, Ch[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h
