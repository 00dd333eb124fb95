"""Nothing the command runs imports JAX or the JAX package, and the
reference imports nothing of the program either. Module names are
compared by their top-level name, whole: the program's package name
begins with the JAX package's."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from benchmark import run
from benchmark.tests.tiny import BENCH, REPO

JAX_SIDE = {"jax", "jaxlib", "flax", "celestia_app_tpu"}
PORT = "celestia_app_tpu_torch"


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
            names |= {f"{node.module}.{a.name}" for a in node.names}
    return names


def _file_of(module: str) -> Path | None:
    parts = module.split(".")
    if parts[0] not in ("benchmark", PORT):
        return None
    for cand in (REPO.joinpath(*parts).with_suffix(".py"), REPO.joinpath(*parts, "__init__.py")):
        if cand.exists():
            return cand
    return None


def _closure(files: list[Path]) -> set[str]:
    """Every module name imported by `files` and, transitively, by the
    benchmark's and the program's modules they import."""
    seen_files, names, todo = set(), set(), list(files)
    while todo:
        f = todo.pop()
        if f in seen_files:
            continue
        seen_files.add(f)
        for name in _imports(f):
            names.add(name)
            target = _file_of(name)
            if target is not None:
                todo.append(target)
    return names


def _harness_files() -> list[Path]:
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]


def test_the_command_imports_no_jax():
    tops = {n.split(".")[0] for n in _closure(_harness_files())}
    assert not tops & JAX_SIDE
    assert PORT in tops  # the walk reaches the program


def test_the_reference_imports_no_program():
    names = _closure(sorted((BENCH / "reference").glob("*.py")) + [BENCH / "check.py", BENCH / "work.py"])
    tops = {n.split(".")[0] for n in names}
    assert not tops & (JAX_SIDE | {PORT})


def test_a_run_loads_no_jax_module():
    code = ("import sys, runpy, glob\n"
            "from benchmark import run, harness, control, check, trace, traffic, spec\n"
            "from celestia_app_tpu_torch.da import edscache\n"
            "from celestia_app_tpu_torch.parallel import mesh_engine, sharded_eds\n"
            "for f in glob.glob('benchmark/e2e/*.py') + glob.glob('benchmark/metrics/*.py'):\n"
            "    spec.load_reader(__import__('pathlib').Path(f))\n"
            "print(run.forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "celestia_app_tpu_torch_shadow", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_shadow", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "celestia_app_tpu.da", sys)
    assert run.forbidden_modules() == ["celestia_app_tpu"]
