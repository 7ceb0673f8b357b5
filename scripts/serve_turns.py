#!/usr/bin/env python3
"""``chip_smoke.py``'s ``serve`` run (Llama3.1-8B at full width, 32 layers,
bf16, through the paged engine and B1 on SERVE's 8 requests) of one tree, so
that two trees can be compared in turns on one CUDA card.

    python3 scripts/serve_turns.py [--tree DIR] [--runs N]

``--tree`` names a checkout (default: this one); its own ``chip_smoke.py``
builds the tree's B1 source, draws the model (``full_model``) and runs
``serve`` without its profiled window ``--runs`` times (default 2) on one
model, each on a fresh engine. Each run prints ``serve``'s own record, then
one summary line: the card and its power limit, the tree, the run's index,
tok/s, the mean, median, prefill-bearing and decode-only step ms, and B1's
launches. Exits 1 without a CUDA card.

To compare a parent commit with a change: unpack the parent under
``build/`` (``git archive``; git-ignored, copied to the card) and run
parent, change, change, parent in one call, each its own process.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path


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
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("serve_turns: no CUDA device", file=sys.stderr)
        return 1
    tree = Path(args.tree).resolve()
    smoke = load_smoke(tree)
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smoke.nvidia_smi()
    _build.build_all(["mixed_paged_attention"])
    model, params, setup = smoke.full_model(torch)
    for i in range(args.runs):
        rec = smoke.serve(torch, smi, model, params, setup, profile=False)
        print(json.dumps(dict(
            phase="serve_turn", card=smi, tree=str(tree), run=i, tok_per_s=rec["tok_per_s"],
            mean_step_ms=rec["mean_step_ms"], median_step_ms=rec["median_step_ms"],
            prefill_step_ms=rec["prefill_step_ms"],
            decode_only_step_ms=rec["decode_only_step_ms"], steps=rec["steps"],
            launches=rec["kernel_launches"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
