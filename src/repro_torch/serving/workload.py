"""Multi-request workload generation (paper Table II) plus shared-prefix
scenarios for the radix prefix cache.

Prompt/output token lengths follow lognormal distributions fitted to the
paper's reported median and P90 (sigma from the 1.2816-quantile); arrivals
are Poisson (exponential inter-arrival), as in Sarathi-Serve and the paper.

``shared_prefix_requests`` (one system prompt, per-request unique suffix)
and ``multi_turn_requests`` (conversations re-submitting their growing
context each turn) materialize REAL token ids — prefix-cache hits are
keyed on token identity, so placeholder ``[0]*L`` prompts would
degenerately alias every request.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

from repro_torch.serving.request import Request


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    name: str
    prompt_median: float
    prompt_p90: float
    out_median: float
    out_p90: float

    def _lognormal(self, rng, median, p90, n):
        mu = math.log(median)
        sigma = max((math.log(p90) - mu) / 1.2816, 1e-3)
        return np.exp(rng.normal(mu, sigma, n))


# paper Table II
OPENCHAT_SHAREGPT4 = WorkloadSpec("openchat_sharegpt4", 1730, 5696, 415, 834)
ARXIV_SUMMARIZATION = WorkloadSpec("arxiv_summarization", 7059, 12985, 208, 371)
WORKLOADS = {w.name: w for w in (OPENCHAT_SHAREGPT4, ARXIV_SUMMARIZATION)}


def sample_requests(
    spec: WorkloadSpec,
    n: int,
    qps: float,
    seed: int = 0,
    max_len: int = 131072,
    vocab_size: int = 32000,
    materialize_tokens: bool = False,
) -> List[Request]:
    """n requests with Poisson arrivals at rate qps.

    The simulator only needs lengths (prompt = [0]*L placeholder); the real
    engine can materialize random token ids with ``materialize_tokens``.
    """
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / qps, n)
    arrivals = np.cumsum(gaps)
    p_lens = np.clip(spec._lognormal(rng, spec.prompt_median, spec.prompt_p90, n), 16, max_len)
    o_lens = np.clip(spec._lognormal(rng, spec.out_median, spec.out_p90, n), 4, max_len)
    reqs = []
    for i in range(n):
        L = int(p_lens[i])
        prompt = (
            rng.integers(0, vocab_size, L).tolist() if materialize_tokens else [0] * L
        )
        reqs.append(
            Request(
                rid=i,
                prompt=prompt,
                max_new_tokens=int(o_lens[i]),
                arrival_time=float(arrivals[i]),
            )
        )
    return reqs


def shared_prefix_requests(
    n: int,
    shared_len: int,
    unique_len: int,
    max_new_tokens: int = 8,
    qps: Optional[float] = None,
    seed: int = 0,
    vocab_size: int = 32000,
    jitter: int = 0,
) -> List[Request]:
    """n requests sharing one system prompt of ``shared_len`` tokens, each
    followed by a ``unique_len``-token user suffix (± ``jitter``). The first
    request prefills and indexes the shared prefix; every later admission
    should hit its full-block run. ``qps=None`` submits everything at t=0
    (the engine's batch regime) so engine and sim schedules coincide."""
    rng = np.random.default_rng(seed)
    system = rng.integers(1, vocab_size, shared_len).tolist()
    arrivals = (np.zeros(n) if qps is None
                else np.cumsum(rng.exponential(1.0 / qps, n)))
    reqs = []
    for i in range(n):
        u = unique_len + (int(rng.integers(-jitter, jitter + 1)) if jitter else 0)
        suffix = rng.integers(1, vocab_size, max(u, 1)).tolist()
        reqs.append(Request(rid=i, prompt=system + suffix,
                            max_new_tokens=max_new_tokens,
                            arrival_time=float(arrivals[i])))
    return reqs


def multi_turn_requests(
    n_users: int,
    n_turns: int,
    turn_len: int,
    response_len: int,
    max_new_tokens: int = 8,
    turn_gap: float = 1.0,
    seed: int = 0,
    vocab_size: int = 32000,
) -> List[Request]:
    """Multi-turn re-submission: each user's turn k re-sends the whole
    conversation so far — turn k-1's prompt, a fixed pseudo-response
    standing in for the assistant's reply, and ``turn_len`` fresh tokens.
    Turn k's prompt therefore begins with turn k-1's prompt verbatim: once
    turn k-1's prefill has completed (and inserted into the radix cache),
    turn k's history is served from shared pages and only the response +
    new-turn tail prefills. rids are user-major (user 0's turns first);
    turn k arrives ``turn_gap`` after turn k-1, so the default gap keeps a
    conversation's turns ordered — ``turn_gap=0`` floods every turn at
    once, which stresses ordering but lets later turns race their own
    history's insertion (hits then depend on scheduling)."""
    rng = np.random.default_rng(seed)
    reqs = []
    rid = 0
    for u in range(n_users):
        history: List[int] = []
        for t in range(n_turns):
            history = history + rng.integers(1, vocab_size, turn_len).tolist()
            reqs.append(Request(rid=rid, prompt=list(history),
                                max_new_tokens=max_new_tokens,
                                arrival_time=float(t) * turn_gap + u * 1e-3))
            rid += 1
            # the assistant's reply becomes conversation context the next
            # turn re-submits (pseudo tokens: outputs are backend-dependent
            # and the cache is keyed on prompt identity, not on them)
            history = history + rng.integers(1, vocab_size, response_len).tolist()
    return reqs
