"""The port stands alone: no file of ``src/repro_torch/``, not
``chip_smoke.py``, not ``tools/calibrate_planner_torch.py`` and none of
the port's examples (``examples/*_torch.py``) imports JAX or the reference
package ``repro``, and the
port's library code prints nothing (the port's counterpart of
tools/check_prints.py, which exempts the reference's ``launch/`` CLIs: the
port's one CLI module there, ``launch/train.py``, prints only in its
``main``)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
FILES = PORT_FILES + [ROOT / "chip_smoke.py", ROOT / "tools" / "calibrate_planner_torch.py",
                      ROOT / "tests" / "torch_lm_worker.py"] \
    + sorted((ROOT / "examples").glob("*_torch.py"))


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_neither_jax_nor_the_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported_modules(tree) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


# modules run as ``python -m``, whose ``main`` writes the reference CLI's lines
CLI_MODULES = {ROOT / "src" / "repro_torch" / name for name in (
    "launch/train.py", "launch/dryrun.py", "launch/components.py", "roofline/analysis.py")}


def _print_lines(tree: ast.AST) -> list[int]:
    return [
        node.lineno for node in ast.walk(tree)
        if isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name) and node.func.id == "print"
    ]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_library_code_does_not_print(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    calls = _print_lines(tree)
    if path in CLI_MODULES:
        mains = [node for node in tree.body if isinstance(node, ast.FunctionDef) and node.name == "main"]
        assert len(mains) == 1 and _print_lines(mains[0])
        calls = sorted(set(calls) - set(_print_lines(mains[0])))
    assert not calls, f"{path.relative_to(ROOT)} calls print at lines {calls}"


def test_the_port_has_the_slice_modules():
    names = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in PORT_FILES}
    assert {
        "core/grammar.py", "core/graph.py", "core/matrices.py",
        "core/closure.py", "core/semantics.py", "core/blocksparse.py",
        "core/conjunctive.py", "baselines/hellings.py",
        "kernels/ref.py", "kernels/bitmm.py", "kernels/ops.py",
        "kernels/tile_bitmm.py", "kernels/minplus.py", "kernels/count_mm.py",
        "obs/trace.py", "obs/metrics.py", "obs/instruments.py",
        "obs/export.py", "obs/chrome.py",
        "delta/txn.py", "delta/repair.py", "engine/stats.py", "engine/config.py",
        "engine/plan.py", "engine/planner.py", "engine/service.py",
        "serve/config.py", "serve/coalesce.py", "serve/server.py",
        "serve/loadgen.py", "serve/__init__.py",
        "shard/__init__.py", "shard/plans.py",
        "configs/__init__.py", "configs/base.py", "configs/registry.py",
        "configs/reduce.py", "models/common.py", "models/attention.py",
        "models/moe.py", "models/transformer.py", "models/weights.py",
        "launch/serve.py", "launch/train.py", "launch/mesh.py", "shard/collectives.py",
        "train/optimizer.py", "train/data.py", "train/checkpoint.py", "train/trainer.py",
        "train/compression.py",
        "models/recsys/deepfm.py",
        "models/gnn/common.py", "models/gnn/so3.py", "models/gnn/simple.py",
        "models/gnn/mace.py", "models/gnn/equiformer_v2.py", "models/gnn/api.py",
        "launch/specs.py", "launch/components.py", "launch/dryrun.py",
        "roofline/hlo.py", "roofline/count.py", "roofline/analysis.py",
    } <= names
    arch_modules = {p.name for p in (ROOT / "src" / "repro" / "configs").glob("*.py")}
    assert {f"configs/{m}" for m in arch_modules} <= names
    for source in ("bitmm.cu", "tile_bitmm.cu", "minplus.cu", "count_mm.cu"):
        assert (ROOT / "src" / "repro_torch" / "kernels" / "csrc" / source).exists()
