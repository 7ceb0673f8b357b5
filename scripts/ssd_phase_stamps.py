#!/usr/bin/env python3
"""Where a B5 item's time goes, on one CUDA card: phase stamps and timing
variants of ``ssd_chunk_scan``'s bf16 kernel.

    python3 scripts/ssd_phase_stamps.py [--src FILE] [--seqs 100,512,4096]

Builds patched copies of the kernel source (default: this checkout's
``src/repro_torch/kernels/csrc/ssd_chunk_scan.cu``) into
``build/ssd_phase_stamps/``, one ``nvcc`` per copy, all at once:

  base     the source as it is
  stamps   thread 0 of each CTA writes clock64 and %globaltimer at the
           item's phase boundaries into the scratch past its layout: item
           start, operands staged, C B^T and W x done, S_c done, the
           predecessor's part of the state awaited, this warp's part
           published, item done
  grid1    one CTA: the items one after another on an idle card (latency)
  nowait   the carry's wait dropped (wrong results; the chain's share)

and runs each on Mamba2-2.7B's widths (nh 80, hd 64, one group of ds 128,
bf16, x, B and C column slices of one conv output, a carried h0) at each
sequence length: device ms (CUDA events, median of 20 calls after an L2
flush) and the largest error against ``ref.ssd_chunk_ref``; then, for
``stamps`` and ``grid1`` (with stamps), the mean and largest of each phase
in microseconds of the SM clock and each chunk's first start, first
publication and last end on the global timer. Prints JSON lines, the card's
clocks last. Exits 1 without a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/csrc"
OUT = ROOT / "build/ssd_phase_stamps"
NH, HD, G, DS = 80, 64, 1, 128
PHASES = ["staged", "cb_w_x", "s_c", "wait", "carry", "post"]  # between stamps 0..6


def sub(text, old, new):
    if old not in text:
        raise ValueError(f"anchor not in the source: {old[:60]!r}")
    return text.replace(old, new, 1)


def patch(src, stamps=False, grid1=False, nowait=False):
    s = src
    if grid1:
        s = sub(s, "  s.grid = (int)std::min<long long>(s.n_items, (long long)CTAS_PER_SM * sms);",
                "  s.grid = 1;")
    if nowait:
        s = sub(s, "    if (lane == 0) wait_carry(a, it, warp);\n", "")
    if stamps:
        s = sub(s, "  float* states;\n};", "  float* states;\n  unsigned long long* stamps;\n};")
        s = sub(s, "struct Item {", """__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long v;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
  return v;
}
#define STAMP(i) do { if (threadIdx.x == 0) { a.stamps[(long long)t * 16 + (i)] = clock64(); \\
  a.stamps[(long long)t * 16 + 8 + (i)] = gtimer(); } } while (0)
struct Item {""")
        at = s.index("ssd_chunk_scan_mma_kernel(const Args a) {")
        head, body = s[:at], s[at:]
        for old, new in [
                ("    const int h = it.h, n = it.n, nd = it.nd;\n", "{0}    STAMP(0);\n"),
                ("    float cb[8][4] = {};\n", "    STAMP(1);\n{0}"),
                ("    // 4. S_c = (x w)^T B", "    STAMP(2);\n{0}"),
                ("    if (lane == 0) wait_carry(a, it, warp);\n", "    STAMP(3);\n{0}    STAMP(4);\n"),
                ("    if (lane == 0) publish_ready(a, it, warp);\n", "{0}    STAMP(5);\n"),
                ("    __syncthreads();  // the next item restages every operand\n",
                 "{0}    STAMP(6);\n")]:
            body = sub(body, old, new.format(old))
        s = head + body
        s = sub(s, "  a.states = reinterpret_cast<float*>(base + s.states);",
                "  a.states = reinterpret_cast<float*>(base + s.states);\n"
                "  a.stamps = reinterpret_cast<unsigned long long*>(base + (s.total + 15) / 16 * 16);")
    return s


VARIANTS = {"base": {}, "stamps": dict(stamps=True), "grid1": dict(stamps=True, grid1=True),
            "nowait": dict(nowait=True)}


def build(src_text):
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, kw in VARIANTS.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(patch(src_text, **kw))
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(CSRC), "-o", str(OUT / f"{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        lib.ssd_chunk_scan_launch.argtypes = [p] * 8 + [i] * 6 + [ll] * 9 + [p, ll, i, i, p]
        lib.ssd_chunk_scan_scratch_layout.argtypes = [i] * 8 + [ctypes.POINTER(ll)]
        libs[name] = lib
        print(json.dumps(dict(variant=name, ptxas=[ln.strip() for ln in log.splitlines()
                                                   if "registers" in ln or "spill" in ln])),
              flush=True)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(CSRC / "ssd_chunk_scan.cu"))
    ap.add_argument("--seqs", default="100,512,4096")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ssd_phase_stamps: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "scripts"))
    from ssd_host_cost import inputs

    from repro_torch.kernels.ref import ssd_chunk_ref

    libs = build(Path(args.src).read_text())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    scratch = torch.zeros(256 * 2**20, dtype=torch.uint8, device="cuda")
    scratch.view(torch.int32)[2] = 1  # the epoch word, which the kernel moves on
    flush = torch.empty(32 * 2**20, dtype=torch.int32, device="cuda")

    def call(name, a):
        x, dt, A, Bm, Cm, h0 = a
        y, hT = torch.empty_like(x), torch.empty_like(h0)
        err = libs[name].ssd_chunk_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            h0.data_ptr(), y.data_ptr(), hT.data_ptr(), 1, x.shape[1], NH, HD, G, DS,
            *x.stride()[:3], *Bm.stride()[:3], *dt.stride(), scratch.data_ptr(), 192 * 2**20,
            sms, 1, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: launch failed ({err})")
        return y, hT

    for S in (int(v) for v in args.seqs.split(",")):
        a = inputs(torch, S, S)
        y_p, h_p = ssd_chunk_ref(a[0].float(), a[1], a[2], a[3].float(), a[4].float(), a[5])
        for name in VARIANTS:
            y, hT = call(name, a)
            torch.cuda.synchronize()
            times = []
            for _ in range(3 if name == "grid1" else 20):
                flush.bitwise_not_()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                call(name, a)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            print(json.dumps(dict(seq=S, variant=name, ms_median=statistics.median(times),
                                  y_max_abs_err=float((y.float() - y_p).abs().max()),
                                  hT_max_abs_err=float((hT - h_p).abs().max()))), flush=True)
        for name in ("stamps", "grid1"):
            out = (ctypes.c_longlong * 6)()
            libs[name].ssd_chunk_scan_scratch_layout(1, S, NH, HD, G, DS, 1, sms, out)
            grid, _, ipc, _, nc, total = list(out)
            at = (total + 15) // 16 * 16
            n = nc * ipc
            scratch[at:at + n * 128].zero_()
            flush.bitwise_not_()
            call(name, a)
            torch.cuda.synchronize()
            st = scratch[at:at + n * 128].view(torch.int64).view(n, 16).cpu().double()
            clk, gt = st[:, :8], st[:, 8:]
            mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                        "--format=csv,noheader,nounits"], capture_output=True,
                                       text=True).stdout.split()[0])
            phases = {p: dict(mean_us=float((clk[:, i + 1] - clk[:, i]).mean()) / mhz,
                              max_us=float((clk[:, i + 1] - clk[:, i]).max()) / mhz)
                      for i, p in enumerate(PHASES)}
            t0 = float(gt[:, 0].min())
            chunks = [dict(chunk=c, first_start_us=(float(gt[c * ipc:(c + 1) * ipc, 0].min()) - t0) / 1e3,
                           first_publish_us=(float(gt[c * ipc:(c + 1) * ipc, 5].min()) - t0) / 1e3,
                           last_end_us=(float(gt[c * ipc:(c + 1) * ipc, 6].max()) - t0) / 1e3)
                      for c in range(nc)]
            print(json.dumps(dict(seq=S, variant=name, grid=grid, items=n,
                                  total_us=(float(gt[:, 6].max()) - t0) / 1e3, phases=phases,
                                  chunks=chunks if nc <= 8 else chunks[:4] + chunks[-4:])),
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
