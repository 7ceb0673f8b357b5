"""The port stands alone: it never imports JAX or the JAX package, and its
copies of the JAX package's host-side modules stay what they were copied
from (imports rewritten to ``repro_torch``, nothing else)."""
from __future__ import annotations

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"

# copied modules, each held to its original: the same code (comments and
# docstrings aside) once `repro.` is rewritten to `repro_torch.` and the
# listed import substitutions are made
COPIES = [
    "configs/__init__.py", "configs/base.py", "configs/llama3_1_8b.py", "configs/mamba2_2_7b.py",
    "configs/reduced.py", "configs/gemma2_2b.py", "configs/qwen2_1_5b.py",
    "configs/chatglm3_6b.py", "configs/qwen3_32b.py", "configs/llama3_1_70b.py",
    "configs/qwen3_moe_30b_a3b.py", "configs/deepseek_v2_236b.py", "configs/jamba_v0_1_52b.py",
    "configs/whisper_small.py", "configs/internvl2_76b.py",
    "serving/request.py", "serving/metrics.py", "serving/workload.py",
    "memory/__init__.py", "memory/block_allocator.py", "memory/tiers.py",
    "memory/prefix_cache.py", "memory/manager.py", "memory/prefetch_queue.py",
    "memory/transfers.py",
    "core/prefetch.py", "core/scheduler.py",
    "obs/__init__.py", "obs/trace.py", "obs/attribution.py", "obs/registry.py",
    "obs/perfetto.py",
    "robustness/__init__.py", "robustness/faults.py", "robustness/degraded.py",
]
IMPORT_SUBS = {  # the scheduler's cost helper lives next to it in the port
    "core/scheduler.py": {"from repro_torch.sim.opcost import kv_tokens_touched":
                          "from repro_torch.core.opcost import kv_tokens_touched"},
}


def _code(text: str) -> str:
    """The module's code as an AST dump, docstrings dropped (comments never
    reach the AST)."""
    tree = ast.parse(text)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(SRC).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def _is_jax_or_reference(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


# modules the walk must reach (it is a glob, so a module that moved or was
# renamed would drop out of the checks silently)
EXPECTED = [
    "repro_torch.kernels.ops", "repro_torch.kernels.decode_attention",
    "repro_torch.kernels.flash_attention", "repro_torch.kernels.paged_attention",
    "repro_torch.kernels.ref", "repro_torch.kernels.ssd", "repro_torch.models.attention",
    "repro_torch.models.mamba", "repro_torch.models.moe", "repro_torch.models.stack",
    "repro_torch.models.model", "repro_torch.serving.serial", "repro_torch.serving.engine",
    "repro_torch.core.packed_step", "repro_torch.weights",
]


@pytest.mark.parametrize("module", EXPECTED)
def test_walk_covers_module(module):
    assert module in _port_modules()


def test_importing_every_module_loads_neither_jax_nor_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, timeout=120, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert not _is_jax_or_reference(name), f"{path}:{node.lineno} imports {name}"


@pytest.mark.parametrize("rel", COPIES)
def test_host_copy_held_to_original(rel):
    original = re.sub(r"\brepro\.", "repro_torch.", (SRC / "repro" / rel).read_text())
    for old, new in IMPORT_SUBS.get(rel, {}).items():
        assert old in original, f"{rel}: substitution {old!r} no longer applies"
        original = original.replace(old, new)
    assert _code((PORT / rel).read_text()) == _code(original), (
        f"src/repro_torch/{rel} drifted from src/repro/{rel}")
