"""What the harness and its reference import, by top-level module name
compared whole (the port, pbte_tpu_torch, begins with pbte_tpu)."""

import ast
import subprocess
import sys

import pytest

from pbte_bench import harness

FILES = sorted(p for p in harness.ROOT.rglob("*.py") if "tests" not in p.parts)
REFERENCE = [p for p in FILES if "reference" in p.parts]


def imported(path):
    """Top-level names of every module ``path`` imports (absolute
    imports; a relative import stays inside pbte_bench)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(harness.ROOT)))
def test_no_jax(path):
    tops = {n.split(".")[0] for n in imported(path)}
    assert not tops & set(harness.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    # the reference's files and the side-neutral modules they import
    seen, todo = set(), list(REFERENCE)
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in imported(path):
            assert name.split(".")[0] != "pbte_tpu_torch", (path, name)
            if name.startswith("pbte_bench"):
                sub = harness.REPO.joinpath(*name.split("."))
                for cand in (sub.with_suffix(".py"), sub / "__init__.py"):
                    if cand.is_file():
                        todo.append(cand)
    assert len(seen) > len(REFERENCE)  # it reached problem.py too


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from pbte_bench import harness\n"
        "from pbte_bench.tests.small import small_config\n"
        "harness.run_cell('legacy_tet.steps.f32', 5, 0.1, True, 'cpu',\n"
        "    config=small_config('legacy_tet_cuboid5_p3'))\n"
        "print(harness.forbidden_modules())\n" % str(harness.REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=harness.REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "pbte_tpu_torch_fake", sys)
    assert "pbte_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert harness.forbidden_modules() == ["jaxlib"]
