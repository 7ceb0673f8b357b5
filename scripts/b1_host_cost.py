#!/usr/bin/env python3
"""Host time a call of B1's wrapper (``mixed_paged_attention``) at the paged
serving engine's shapes, on one CUDA card.

    python3 scripts/b1_host_cost.py [--src DIR] [--rounds N]

``--src`` names the ``src`` directory whose ``repro_torch`` is measured
(default: this checkout's), so that two trees can be compared on one card,
in turns. Two steps of ``chip_smoke.py``'s SERVE workload at Llama3.1-8B's
attention heads (KV 8, G 4, d 128, bf16, pages of 16, tables of 8192 keys,
a pool of 4096 pages): a decode-only step of 8 rows of 600-3600 keys, and
a mixed step of the same rows beside a 512-row chunk at 1024 keys. A round
issues one step's 32 calls back to back, as the engine issues its layers'
calls, and then synchronises; its host time a call is the issue time over
32. Prints one JSON line: the card, its power limit, the tree, and per step
the median and lowest of the rounds' host microseconds a call and the
device milliseconds a call (CUDA events over a round, after the host has
queued it). Exits 1 without a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

LAYERS = 32
KV, G, D, PAGE, MAX_LEN, POOL = 8, 4, 128, 16, 8192, 4096
DECODE_LENS = [600, 1030, 1460, 1890, 2320, 2750, 3180, 3600]


def step(torch, pa, rng, q_lens, kv_lens):
    """One packed step's B1 inputs on the card: q, cu_q_lens, kv_lens, block
    tables (distinct live pages, the rest any page) and the q-tile list."""
    nb = MAX_LEN // PAGE
    pages = rng.integers(0, POOL, (len(q_lens), nb))
    live = rng.permutation(POOL)
    for s, n in enumerate(kv_lens):
        n_pages = -(-n // PAGE)
        pages[s, :n_pages], live = live[:n_pages], live[n_pages:]
    cu = [0]
    for n in q_lens:
        cu.append(cu[-1] + n)
    dev = dict(device="cuda")
    i32 = dict(dtype=torch.int32, **dev)
    q = torch.randn((cu[-1], KV, G, D), dtype=torch.bfloat16, **dev)
    return (q, torch.tensor(cu, **i32), torch.tensor(kv_lens, **i32),
            torch.tensor(pages, **i32),
            torch.from_numpy(pa.q_tiles(np.asarray(cu), G)).to("cuda"))


def measure(torch, pa, k_pool, v_pool, inputs, rounds):
    q, cu, kv_lens, tables, tiles = inputs

    def call():
        return pa.mixed_paged_attention(q, k_pool, v_pool, cu, kv_lens, tables, tiles=tiles)

    for _ in range(5):
        call()
    torch.cuda.synchronize()
    host, dev = [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(rounds):
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        for _ in range(LAYERS):
            call()
        host.append((time.perf_counter() - t0) / LAYERS * 1e6)
        end.record()
        torch.cuda.synchronize()
        dev.append(start.elapsed_time(end) / LAYERS)
    return dict(host_us_median=statistics.median(host), host_us_min=min(host),
                device_ms_median=statistics.median(dev), rounds=rounds)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--rounds", type=int, default=200)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("b1_host_cost: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import paged_attention as pa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    k_pool, v_pool = (torch.randn((POOL, PAGE, KV, D), generator=gen, dtype=torch.bfloat16,
                                  device="cuda") for _ in range(2))
    steps = {"decode_only": step(torch, pa, rng, [1] * 8, DECODE_LENS),
             "mixed": step(torch, pa, rng, [1] * 8 + [512], DECODE_LENS + [1024])}
    launches = pa.mixed_paged_attention.launches
    out = {name: measure(torch, pa, k_pool, v_pool, inputs, args.rounds)
           for name, inputs in steps.items()}
    print(json.dumps(dict(card=smi, src=args.src, module=pa.__file__,
                          launches=pa.mixed_paged_attention.launches - launches, **out)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
