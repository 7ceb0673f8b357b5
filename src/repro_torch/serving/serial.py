"""Serial execution: one request at a time, the baseline the paper's packing
is measured against ("over the serial execution") and the oracle the packed
engine is held to token for token.

A request runs alone over its own cache (a dense KV cache, or Mamba2's
conv and SSM state): one ``Model.prefill`` of the whole prompt from position
0, then one ``Model.decode_step`` per new token, greedy (first maximum on a
tie, as the engine samples). Every decode step
streams all the weights for a single token; a packed step shares that read
among its rows.
"""
from __future__ import annotations

from typing import Iterator, List, Sequence

import torch

from repro_torch.models.model import Model


def serial_tokens(model: Model, params, prompt: Sequence[int], max_new_tokens: int, *,
                  max_len: int) -> Iterator[int]:
    """Yield the request's greedy tokens as they are produced: the first
    after the prefill, then one per decode step, over a fresh
    ``model.init_cache(1, max_len)``. Each token is read back to the host
    before it is yielded, so a caller's clock between yields times the
    device work."""
    if len(prompt) + max_new_tokens - 1 > max_len:
        raise ValueError(f"{len(prompt)} prompt + {max_new_tokens} new tokens exceed "
                         f"max_len {max_len}")
    cache = model.init_cache(1, max_len)
    dev = model.device
    tokens = torch.tensor([list(prompt)], dtype=torch.int32, device=dev)
    logits, cache = model.prefill(params, {"tokens": tokens}, cache, 0)
    tok = int(torch.argmax(logits[0]))
    yield tok
    pos = len(prompt)
    for _ in range(max_new_tokens - 1):
        step = torch.tensor([[tok]], dtype=torch.int32, device=dev)
        logits, cache = model.decode_step(params, step, cache, pos)
        tok = int(torch.argmax(logits[0]))
        yield tok
        pos += 1


def serial_reference(model: Model, params, prompt: Sequence[int], max_new_tokens: int, *,
                     max_len: int) -> List[int]:
    """The request's greedy tokens, served alone."""
    return list(serial_tokens(model, params, prompt, max_new_tokens, max_len=max_len))
