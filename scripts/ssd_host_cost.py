#!/usr/bin/env python3
"""B5's wrapper (``ssd_chunk_scan``) on one CUDA card: its host time a call at
the two-call engine's shapes, and optionally a tree's own B5 parity cases and
its ``serve_mamba`` run, so that two trees can be compared in turns.

    python3 scripts/ssd_host_cost.py [--tree DIR] [--rounds N] [--cases] [--serve]

``--tree`` names a checkout (default: this one); its ``src/repro_torch`` is
measured, and with ``--cases`` / ``--serve`` its own ``chip_smoke.py`` runs
``ssd_parity`` (every ``b5_*`` case: parity, faults, device times) and
``full_model`` + ``mamba_engine_check`` + ``serve`` on Mamba2-2.7B (the
``serve_mamba`` and ``serve_mamba_profile`` records). Those print their own
JSON lines.

The host time: one layer's B5 inputs of Mamba2-2.7B (nh 80, hd 64, one
group of ds 128, bf16; x, B and C column slices of one conv output, as the
model hands them over; a carried fp32 state) for a 512-token segment and a
100-token one. A round issues a segment's 64 calls back to back, as the
engine issues its layers' calls, and then synchronises; its host time a
call is the issue time over 64. Prints one JSON line: the card, its power
limit, the tree, and per segment the median and lowest of the rounds' host
microseconds a call and the device milliseconds a call (CUDA events over a
round, after the host has queued it). Exits 1 without a CUDA card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

LAYERS = 64
NH, HD, G, DS = 80, 64, 1, 128


def inputs(torch, seq, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d_in = NH * HD
    xbc = torch.randn((1, seq, d_in + 2 * G * DS), generator=gen, device="cuda")
    xbc = xbc.to(torch.bfloat16)
    x = xbc[..., :d_in].unflatten(-1, (NH, HD))
    Bm = xbc[..., d_in:d_in + G * DS].unflatten(-1, (G, DS))
    Cm = xbc[..., d_in + G * DS:].unflatten(-1, (G, DS))
    dt = torch.nn.functional.softplus(torch.randn((1, seq, NH), generator=gen, device="cuda") - 4)
    A = -torch.arange(1, NH + 1, dtype=torch.float32, device="cuda")
    h0 = torch.randn((1, NH, HD, DS), generator=gen, device="cuda")
    return x, dt, A, Bm, Cm, h0


def measure(torch, fn, args, rounds):
    for _ in range(5):
        fn(*args)
    torch.cuda.synchronize()
    host, dev = [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(rounds):
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        for _ in range(LAYERS):
            fn(*args)
        host.append((time.perf_counter() - t0) / LAYERS * 1e6)
        end.record()
        torch.cuda.synchronize()
        dev.append(start.elapsed_time(end) / LAYERS)
    return dict(host_us_median=statistics.median(host), host_us_min=min(host),
                device_ms_median=statistics.median(dev), rounds=rounds)


def load_smoke(tree: Path):
    """The tree's own chip_smoke.py as a module (it puts the tree's src first
    on the path)."""
    spec = importlib.util.spec_from_file_location("tree_chip_smoke", tree / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--cases", action="store_true", help="run the tree's b5_* parity cases")
    ap.add_argument("--serve", action="store_true", help="run the tree's serve_mamba")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ssd_host_cost: no CUDA device", file=sys.stderr)
        return 1
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import ssd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    launches = ssd.ssd_chunk_scan.launches
    out = {f"s{seq}": measure(torch, ssd.ssd_chunk_scan, inputs(torch, seq, seq), args.rounds)
           for seq in (512, 100)}
    print(json.dumps(dict(phase="ssd_host_cost", card=smi, tree=str(tree), module=ssd.__file__,
                          launches=ssd.ssd_chunk_scan.launches - launches, **out)), flush=True)
    if args.cases or args.serve:
        smoke = load_smoke(tree)
        if args.cases:
            smoke.ssd_parity(torch)
        if args.serve:
            model, params, setup = smoke.full_model(torch, "mamba2-2.7b")
            smoke.mamba_engine_check(torch, model, params)
            smoke.serve(torch, smi, model, params, setup, attn_kernel="auto")
    return 0


if __name__ == "__main__":
    sys.exit(main())
