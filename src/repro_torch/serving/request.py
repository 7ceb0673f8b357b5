"""Request lifecycle for the serving engine and the service-level simulator."""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, List, Optional


class State(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    SWAPPED = "swapped"  # KV spilled to host DRAM, awaiting re-admission
    DONE = "done"
    # terminal without completing: deadline expired or engine shut down.
    # Everything the request held (slot, allocator refs, prefix-cache refs,
    # ledger intents, host swap records) is released at cancellation;
    # finish_time stays None so it never counts as a completed request.
    CANCELLED = "cancelled"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]  # token ids (engine) — sim only uses len(prompt)
    max_new_tokens: int
    arrival_time: float = 0.0
    priority: int = 0  # higher = more important (admission + preemption victim order)
    frames: Optional[Any] = None  # audio frontend stub embeddings (enc-dec archs)
    # absolute deadline on the driving clock (engine: steps, sim: seconds);
    # None = no deadline. SchedulerConfig.request_timeout (relative to
    # arrival) composes with this — the earlier of the two wins.
    deadline: Optional[float] = None

    state: State = State.QUEUED
    slot: Optional[int] = None
    prefill_pos: int = 0  # effective-prompt tokens already prefilled
    output: List[int] = dataclasses.field(default_factory=list)
    # set by the engine when an EOS token is sampled: the request completes
    # at the next complete_step without max_new_tokens being rewritten (the
    # requested length survives for metrics and recompute rebuilds)
    finished: bool = False

    # preemption bookkeeping: a recompute-preempted decode drops its KV and
    # re-prefills its *effective prompt* = prompt + the output tokens
    # generated so far; a swap-preempted decode keeps all state and its KV
    # moves to host DRAM until re-admission.
    restart_output_len: int = 0  # output tokens baked into the current prefill
    preemptions: int = 0  # times this request was preempted (either kind)
    swaps: int = 0  # times this request was swapped out to host
    # prompt tokens adopted from the radix prefix cache at the most recent
    # admission (copy-on-write shared pages; prefill skips them entirely)
    cached_prefix_len: int = 0
    # why the request was cancelled ("deadline", "shutdown", ...); None
    # unless state is CANCELLED
    cancel_reason: Optional[str] = None

    # timing (engine: wall clock; sim: simulated seconds)
    schedule_time: Optional[float] = None  # first time any chunk ran
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def total_prefill_len(self) -> int:
        """Length of the effective prompt: original prompt plus any output
        tokens that must be recomputed after a preemption."""
        return len(self.prompt) + self.restart_output_len

    @property
    def context_len(self) -> int:
        """Tokens currently in this request's KV cache."""
        return self.prefill_pos + max(0, len(self.output) - self.restart_output_len)

    @property
    def prefill_done(self) -> bool:
        return self.prefill_pos >= self.total_prefill_len

    @property
    def next_decode_pos(self) -> int:
        """Cache position at which the next decode step writes its KV (the
        position of the last sampled token, not yet in the cache)."""
        return self.prefill_pos + len(self.output) - self.restart_output_len - 1

    def prefill_slice(self, start: int, length: int) -> List[int]:
        """Token ids [start, start+length) of the effective prompt."""
        if self.restart_output_len == 0:
            return self.prompt[start : start + length]
        seq = self.prompt + self.output[: self.restart_output_len]
        return seq[start : start + length]

    def tbt_latencies(self) -> List[float]:
        """Time-between-tokens samples (decode-phase inter-token gaps)."""
        ts = self.token_times
        return [b - a for a, b in zip(ts, ts[1:])]
