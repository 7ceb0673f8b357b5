"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes); the
``csrc/*.cuh`` headers are shared by the sources:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -lcuda \
         -o build/repro_torch_kernels/<name>-<hash>.so <name>.cu

(``-lcuda`` links libcuda for ``cuTensorMapEncodeTiled``, with which B4's
launcher builds its TMA descriptors.)

The build happens on first use, into ``build/repro_torch_kernels/`` at the
repository root, keyed by a hash of the source, the headers and the flags,
so an edited source rebuilds and an unchanged one is loaded as it is.
``build_all`` starts one ``nvcc`` per source at once. A failed build raises
with the compiler's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-lcuda")


@dataclasses.dataclass
class Built:
    name: str
    path: Path
    seconds: float  # compile time in this process (0.0 when already built)
    log: str  # nvcc's output (ptxas register / shared-memory report)


_LOADED: Dict[str, ctypes.CDLL] = {}  # process-wide: a library loads once


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the "
                           "CUDA toolkit (CUDA_HOME, /usr/local/cuda or PATH)")
    return found


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all(names: Sequence[str]) -> List[Built]:
    """Build ``csrc/<name>.cu`` for every name whose library is not up to
    date, one ``nvcc`` process per source, all started together."""
    built, running = {}, []
    for name in names:
        src = CSRC / f"{name}.cu"
        out = _target(src)
        if out.exists():
            built[name] = Built(name, out, 0.0, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, src, out, tmp, proc, time.perf_counter()))
    failed = []
    for name, src, out, tmp, proc, t0 in running:  # wait for every process
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        built[name] = Built(name, out, time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return [built[name] for name in names]


def build(name: str) -> Built:
    """Build ``csrc/<name>.cu`` unless its library is up to date."""
    return build_all([name])[0]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build(name).path))
    return lib
