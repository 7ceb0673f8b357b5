#!/usr/bin/env python3
"""Where a B3 call's time goes, on one CUDA card: phase stamps and timing
variants of ``decode_attention``'s bf16 path.

    python3 scripts/b3_phase_stamps.py [--parent DIR] [--cases serial,gemma2]

Builds patched copies of ``src/repro_torch/kernels/csrc/decode_attention.cu``
into ``build/b3_phase_stamps/``, one ``nvcc`` per copy, all at once: the
source as it is and with stamps; with ``--parent DIR`` (a tree of the same
repository, e.g. a ``git archive`` of an earlier commit under ``build/``)
also that tree's source as it is and with stamps, where B3's bf16 path is
its per-row kernel, split over ``split_count`` CTAs, and a combine pass.
Stamps: thread 0 of each CTA writes clock64 and %globaltimer at its phase
boundaries into a device array past the kernel's own memory:

  cluster kernel  start, q's loads issued, first blocks requested, first
                  block landed, its products done, last block landed, the
                  loop drained, the warps' partials stored, every peer
                  started, the merged partials sent to their ranks, after
                  the cluster barrier, its slice of the outputs written
                  (and the SM it ran on)
  row kernel      start, q loaded, first block requested, first block
  (parent)        landed, its products done, last block landed, the loop
                  drained, partials written; the combine kernel's start and
                  end

Each case (``serial``: Llama3.1-8B's serial decode, one row at 4096 of an
8192 cache, KV 8, G 4, d 128; ``gemma2``: one row at 6000 of 8192, KV 4, G
2, d 256, window 4096, softcap 50, q scaled by 64; NaN in every dead key)
runs each build at each launch shape it takes (the cluster kernel at C 8
and 16 and rings of 2 and 4 blocks where they fit, with the card's count of
clusters held at once for C 1 to 16; the cluster builds also at the
wrapper's plan over the same cache stored head-major, each head's keys
contiguous): device ms (CUDA events, median of 50 calls, each after
an L2 flush: ``ms_median`` after rewriting a 128 MB buffer, as
``chip_smoke.py`` flushes, which leaves L2 full of dirty lines;
``ms_clean_median`` after reading it, which leaves clean ones) and its
error against ``ref.decode_attention_ref`` (``tol_used`` as
``chip_smoke.py`` computes it); then, for the stamped builds at the
shapes the wrappers pick, five calls: the mean and largest of each phase
over the CTAs that had keys, in SM clock cycles and in microseconds at the
card's largest SM clock (with the clock each CTA ran at, from its two
timers), and the grid's timeline on the global timer (medians of the
calls). Prints JSON lines, the card's clocks last. Exits 1 without a CUDA
card.
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
OUT = ROOT / "build/b3_phase_stamps"
MAX_CTAS = 4096
CLUSTER_PHASES = ["q", "request", "first_landed", "first_products", "to_last_landed",
                  "drain", "partials", "start_wait", "merge_send", "barrier",
                  "combine"]  # between stamps 0..11
ROW_PHASES = ["q", "request", "first_landed", "first_products", "to_last_landed", "drain",
              "partials"]  # between stamps 0..7

STAMP_HEAD = """
__device__ unsigned long long b3_stamps[%d * 32];
__device__ unsigned long long b3_stamps2[%d * 32];
__device__ __forceinline__ unsigned long long b3_gtimer() {
  unsigned long long v;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(v));
  return v;
}
__device__ __forceinline__ long long b3_cta() {
  return blockIdx.x + (long long)gridDim.x * (blockIdx.y + (long long)gridDim.y * blockIdx.z);
}
__device__ __forceinline__ unsigned b3_smid() {
  unsigned v;
  asm volatile("mov.u32 %%0, %%%%smid;" : "=r"(v));
  return v;
}
#define STAMP(i) do { if (threadIdx.x == 0) { b3_stamps[b3_cta() * 32 + (i)] = clock64(); \\
  b3_stamps[b3_cta() * 32 + 16 + (i)] = b3_gtimer(); \\
  b3_stamps[b3_cta() * 32 + 15] = b3_smid(); } } while (0)
#define STAMP2(i) do { if (threadIdx.x == 0) { b3_stamps2[b3_cta() * 32 + (i)] = clock64(); \\
  b3_stamps2[b3_cta() * 32 + 16 + (i)] = b3_gtimer(); } } while (0)
""" % (MAX_CTAS, MAX_CTAS)

STAMP_TAIL = """
extern "C" int b3_stamps_read(void* dst, void* dst2) {
  cudaError_t e = cudaMemcpyFromSymbol(dst, b3_stamps, sizeof(b3_stamps));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(dst2, b3_stamps2, sizeof(b3_stamps2));
  return int(e);
}
extern "C" int b3_stamps_clear() {
  static const unsigned long long zero[%d * 32] = {};
  cudaError_t e = cudaMemcpyToSymbol(b3_stamps, zero, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(b3_stamps2, zero, sizeof(zero));
  return int(e);
}
""" % MAX_CTAS


def sub(text, old, new):
    if old not in text:
        raise ValueError(f"anchor not in the source: {old[:70]!r}")
    return text.replace(old, new, 1)


def stamp_cluster(src):
    """Stamps in ``cluster_decode_kernel``."""
    s = sub(src, "namespace {\n", STAMP_HEAD + "namespace {\n")
    at = s.index("cluster_decode_kernel(\n")
    head, body = s[:at], s[at:]
    for old, new in [
            ("  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;\n", "{0}  STAMP(0);\n"),
            ("    rows.load_q(q, qbase, g);\n  }\n", "{0}  STAMP(1);\n"),
            ("    for (int t = 0; t < slots; ++t) copy(t);  // the group's first blocks\n",
             "{0}  STAMP(2);\n"),
            ("      const int b = grp + ng * t;\n",
             "      if (t == 0) STAMP(3);\n      if (t == mine - 1) STAMP(5);\n{0}"),
            ("scale, softcap);\n      if (t + slots < mine) {\n",
             "scale, softcap);\n      if (t == 0) STAMP(4);\n      if (t + slots < mine) {{\n"),
            ("  __syncthreads();  // the ring is free: the merge reuses it\n", "{0}  STAMP(6);\n"),
            ("  hop::cluster_wait();  // every peer has started\n", "  STAMP(7);\n{0}  STAMP(8);\n"),
            ("  hop::cluster_sync();  // every CTA's partials are where they are combined\n",
             "  STAMP(9);\n{0}  STAMP(10);\n"),
            ("pack_bf16(a.z * il, a.w * il));\n    }\n  }\n}\n",
             "pack_bf16(a.z * il, a.w * il));\n    }}\n  }}\n  STAMP(11);\n}}\n")]:
        body = sub(body, old, new.format(old))
    return head + body + STAMP_TAIL


def stamp_rows(src):
    """Stamps in the parent's ``row_attention_kernel`` and
    ``combine_splits_kernel``."""
    s = sub(src, "namespace {\n", STAMP_HEAD + "namespace {\n")
    for old, new in [
            ("  const int n = blockIdx.x, h = blockIdx.y, split = blockIdx.z;\n", "{0}  STAMP(0);\n"),
            ("  __syncthreads();\n  if (STAGES == 2 && lo < hi) stage(0, lo);\n",
             "  __syncthreads();\n  STAMP(1);\n  if (STAGES == 2 && lo < hi) stage(0, lo);\n"
             "  STAMP(2);\n"),
            ("    __syncthreads();\n    const T* ks = kv_s + buf * 2 * BK * KS;\n",
             "    __syncthreads();\n    if (kb == lo) STAMP(3);\n    if (kb + BK >= hi) STAMP(5);\n"
             "    const T* ks = kv_s + buf * 2 * BK * KS;\n"),
            ("    __syncthreads();  // the next iteration's copy reuses this stage\n"
             "    if (STAGES == 2) buf ^= 1;\n  }\n",
             "    __syncthreads();  // the next iteration's copy reuses this stage\n"
             "    if (kb == lo) STAMP(4);\n    if (STAGES == 2) buf ^= 1;\n  }}\n  STAMP(6);\n"),
            ("    ml_part[2 * (pbase + tid) + 1] = l_s[tid];\n  }\n}\n",
             "    ml_part[2 * (pbase + tid) + 1] = l_s[tid];\n  }}\n  __syncthreads();\n"
             "  STAMP(7);\n}}\n"),
            ("  const long long pair = blockIdx.x;\n", "{0}  STAMP2(0);\n"),
            ("    out[(pair * g + r) * d + x] = from_float<T>(o / fmaxf(l_all, 1e-37f));\n  }\n}\n",
             "    out[(pair * g + r) * d + x] = from_float<T>(o / fmaxf(l_all, 1e-37f));\n  }}\n"
             "  __syncthreads();\n  STAMP2(1);\n}}\n")]:
        s = sub(s, old, new.format(old))
    return s + STAMP_TAIL


NO_PRODUCTS = "      rows.block(ks, ks + BK * KSTR, lo + b * BK + wg * CL_KW, lo, hi, scale, softcap);\n"
HINTED = ("        cp_async16_hint(ks + c * KSTR + x, k + off, ok, policy);\n"
          "        cp_async16_hint(vs + c * KSTR + x, v + off, ok, policy);\n")
PLAIN = ("        cp_async16(ks + c * KSTR + x, k + off, ok);\n"
         "        cp_async16(vs + c * KSTR + x, v + off, ok);\n")


def variants(prefix, text):
    """The builds of one tree: as it is and stamped; for the cluster kernel
    also without its products (the copies' floor, wrong results) and with
    its K/V copies under L2's normal policy instead of evict-first."""
    if prefix != "cluster":
        return {prefix: text, prefix + "_stamps": stamp_rows(text)}
    return {"cluster": text, "cluster_stamps": stamp_cluster(text),
            "cluster_noproducts": sub(text, NO_PRODUCTS, ""),
            "cluster_l2normal": sub(text, HINTED, PLAIN)}


def build(trees):
    """``trees``: {prefix: csrc directory}; builds each tree's variants,
    all at once."""
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for prefix, csrc in trees.items():
        text = (csrc / "decode_attention.cu").read_text()
        for name, body in variants(prefix, text).items():
            cu = OUT / f"{name}.cu"
            cu.write_text(body)
            procs[name] = subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
                 str(OUT / f"{name}.so"), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        if name.startswith("cluster"):
            lib.decode_cluster_launch.argtypes = [p] * 5 + [i, i, ll, ll, ll, i, i, i, i, i, f, f,
                                                            i, p]
            lib.decode_cluster_occupancy.argtypes = [i, i, i, i, ctypes.POINTER(i)]
        else:
            lib.decode_attention_launch.argtypes = [p] * 7 + [i, i, ll, ll, ll, i, i, i, i, f, f,
                                                              i, i, p]
        if name.endswith("_stamps"):
            lib.b3_stamps_read.argtypes = [p, p]
        libs[name] = lib
        print(json.dumps(dict(build=name, ptxas=[ln.strip() for ln in log.splitlines()
                                                 if "registers" in ln or "spill" in ln])),
              flush=True)
    return libs


CASES = {
    "serial": dict(seed=100, lengths=[4096], kv=8, g=4, d=128, cap=8192),
    "gemma2": dict(seed=116, lengths=[6000], kv=4, g=2, d=256, cap=8192, window=4096,
                   softcap=50.0, q_scale=64.0, nan_left_of_window=False),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a tree whose B3 bf16 path is the per-row kernel")
    ap.add_argument("--cases", default="serial,gemma2")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("b3_phase_stamps: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from chip_smoke import row_case, tol_used

    from repro_torch.kernels.decode_attention import cluster_plan, split_count
    from repro_torch.kernels.ref import decode_attention_ref

    trees = {"cluster": CSRC}
    if args.parent:
        trees["parent"] = Path(args.parent).resolve() / "src/repro_torch/kernels/csrc"
    libs = build(trees)
    flush = torch.empty(32 * 2**20, dtype=torch.int32, device="cuda")
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True).stdout.split()[0])

    for cname in args.cases.split(","):
        kw = dict(CASES[cname])
        seed, lengths = kw.pop("seed"), kw.pop("lengths")
        case = row_case(torch, seed, lengths, dtype=torch.bfloat16, **kw)
        q, k, v, lens = case["q"], case["k"], case["v"], case["lens"]
        N, KV, G, d = q.shape
        S = k.shape[1]
        w, cap = case["window"], case["softcap"]
        plain = decode_attention_ref(q.float(), k.float(), v.float(), lens, window=w, softcap=cap)
        sb, ss, sh, _ = k.stride()
        stream = torch.cuda.current_stream().cuda_stream
        scalars = (1.0 / d**0.5, 0.0 if cap is None else cap, 0 if w is None else w)
        n_split = split_count(N * KV, S)
        part = torch.empty(N * KV * n_split * G * (d + 2), dtype=torch.float32, device="cuda")

        # the same cache stored head-major (each KV head's keys contiguous),
        # read through its strides: what the access order costs
        kh, vh = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (k, v))

        def launch(name, shape, kk=k, vv=v):
            out = torch.empty_like(q)
            lib = libs[name]
            if name.startswith("cluster"):
                C, stages = shape
                kb, ks_, kh_, _ = kk.stride()
                err = lib.decode_cluster_launch(q.data_ptr(), kk.data_ptr(), vv.data_ptr(),
                                                out.data_ptr(), lens.data_ptr(), N, S, kb, ks_,
                                                kh_, KV, G, d, C, stages, *scalars, stream)
            else:
                err = lib.decode_attention_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), part.data_ptr(),
                    part.data_ptr() + 4 * N * KV * n_split * G * d, lens.data_ptr(), N, S, sb, ss,
                    sh, KV, G, d, shape, *scalars, 1, stream)
            if err:
                raise RuntimeError(f"{name} {shape}: launch failed ({err})")
            return out

        shapes = {"parent": [n_split]} if args.parent else {}
        plan = cluster_plan(N * KV, S, d)
        depths = [st for st in (2, 4) if st * 2 * 64 * (d + 8) * 2 <= 212992]
        held = {}  # clusters the card holds at once, by (C, stages)
        for C in (1, 2, 4, 8, 16):
            for st in depths:
                active = ctypes.c_int(0)
                libs["cluster"].decode_cluster_occupancy(d, G, C, st, ctypes.byref(active))
                held[f"{C}x{st}"] = active.value
        print(json.dumps(dict(case=cname, max_active_clusters=held)), flush=True)
        for name in libs:
            if name.startswith("cluster") and not name.endswith("_stamps"):
                shapes[name] = [(C, st) for C in (8, 16) for st in depths]
        for name in ("cluster", "cluster_noproducts"):  # the head-major cache at the plan
            times = []
            for _ in range(50):
                flush.bitwise_not_()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                launch(name, plan, kh, vh)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            print(json.dumps(dict(case=cname, build=name, shape=plan, layout="head_major",
                                  ms_median=statistics.median(times))), flush=True)
        del kh, vh
        for name, launch_shapes in shapes.items():
            for shape in launch_shapes:
                rec = dict(case=cname, build=name, shape=shape, plan=shape == plan)
                if name.startswith("cluster"):
                    active = ctypes.c_int(0)
                    libs[name].decode_cluster_occupancy(d, G, shape[0], shape[1],
                                                        ctypes.byref(active))
                    rec.update(max_active_clusters=active.value, clusters=N * KV)
                    if active.value < 1:  # the launch would be refused
                        print(json.dumps(rec), flush=True)
                        continue
                got = launch(name, shape)
                torch.cuda.synchronize()
                for kind in ("dirty", "clean"):
                    times = []
                    for _ in range(50):
                        if kind == "dirty":  # as chip_smoke.py: L2 left full of dirty lines
                            flush.bitwise_not_()
                        else:  # L2 left full of clean lines
                            flush.sum()
                        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                        start.record()
                        launch(name, shape)
                        end.record()
                        torch.cuda.synchronize()
                        times.append(start.elapsed_time(end))
                    key = "ms_median" if kind == "dirty" else "ms_clean_median"
                    rec[key] = statistics.median(times)
                rec["tol_used"] = tol_used(got.float(), plain, "bfloat16")
                print(json.dumps(rec), flush=True)
        for name in ("parent", "cluster") if args.parent else ("cluster",):
            lib = libs[name + "_stamps"]
            shape = plan if name == "cluster" else n_split
            runs = []
            for _ in range(5):
                flush.bitwise_not_()
                lib.b3_stamps_clear()
                launch(name + "_stamps", shape)
                torch.cuda.synchronize()
                st = np.zeros(MAX_CTAS * 32, np.uint64)
                st2 = np.zeros(MAX_CTAS * 32, np.uint64)
                lib.b3_stamps_read(st.ctypes.data, st2.ctypes.data)
                runs.append((st.reshape(MAX_CTAS, 32).astype(np.float64),
                             st2.reshape(MAX_CTAS, 32).astype(np.float64)))
            ctas = (shape[0] if name == "cluster" else n_split) * N * KV
            phases = CLUSTER_PHASES if name == "cluster" else ROW_PHASES
            rows = np.concatenate([r[0][:ctas] for r in runs])
            clk, gt = rows[:, :16], rows[:, 16:]
            full = (clk[:, 3] > 0) & (clk[:, 5] > 0)  # CTAs that had keys
            last = len(phases)
            # the SM clock over each CTA's life, from its two timers
            timer_mhz = float(np.median((clk[full, last] - clk[full, 0])
                                        / (gt[full, last] - gt[full, 0]) * 1e3))
            per_sm = np.unique(runs[0][0][:ctas, 15], return_counts=True)[1]
            rec = dict(case=cname, build=name + "_stamps", shape=shape, ctas=ctas,
                       sms_used=int(per_sm.size), most_ctas_an_sm=int(per_sm.max()),
                       ctas_with_keys=int(full.sum()) // len(runs), runs=len(runs),
                       clock_max_mhz=mhz, clock_mhz_from_timer=timer_mhz,
                       phases_cycles={p: dict(mean=float((clk[full, i + 1] - clk[full, i]).mean()),
                                              max=float((clk[full, i + 1] - clk[full, i]).max()))
                                      for i, p in enumerate(phases)})
            rec["phases_us_at_max_clock"] = {p: dict(mean=v["mean"] / mhz, max=v["max"] / mhz)
                                             for p, v in rec["phases_cycles"].items()}
            spans = []
            for st, st2 in runs:
                g0 = st[:ctas, 16].min()
                span = dict(first_start_us=0.0,
                            last_start_us=(st[:ctas, 16].max() - g0) / 1e3,
                            first_landed_us=(st[:ctas, 16 + 3][st[:ctas, 16 + 3] > 0].min() - g0)
                            / 1e3,
                            last_landed_us=(st[:ctas, 16 + 5].max() - g0) / 1e3,
                            last_end_us=(st[:ctas, 16 + last].max() - g0) / 1e3)
                if name == "parent":
                    n2 = N * KV * G
                    span.update(combine_first_start_us=(st2[:n2, 16].min() - g0) / 1e3,
                                combine_last_end_us=(st2[:n2, 17].max() - g0) / 1e3,
                                combine_mean_us=float((st2[:n2, 1] - st2[:n2, 0]).mean()) / mhz)
                spans.append(span)
            rec["timeline_us"] = {key: statistics.median(s[key] for s in spans)
                                  for key in spans[0]}
            print(json.dumps(rec), flush=True)
        del case, q, k, v, plain, part
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
