"""Nothing the benchmark runs imports JAX, Flax or the JAX package
`openhevc_tpu`, by whole top-level name (the port `openhevc_tpu_torch`
begins with the JAX package's name): neither in its sources nor in the
process of a run. And nothing of the benchmark runs without the
program beside it."""
import ast
import os
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "openhevc_tpu"}


def imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    seen = set()
    for path in sources():
        for name in imported(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN, (path, name)
            seen.add(top)
    assert "openhevc_tpu_torch" in seen and "torch" in seen


def test_the_scan_compares_whole_top_level_names(monkeypatch):
    monkeypatch.syspath_prepend(BENCH)
    import run
    monkeypatch.setitem(sys.modules, "openhevc_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxlibrary", sys)
    monkeypatch.setitem(sys.modules, "openhevc_tpu.decoder", sys)
    found = run.loaded_forbidden()
    assert "openhevc_tpu.decoder" in found
    assert "openhevc_tpu_torch" not in found
    assert not {"openhevc_tpu_torch_x", "jaxlibrary"} & set(found)


SNIPPET = r"""
import sys
sys.path[:0] = [{root!r}, {bench!r}]
sys.path.insert(0, {tests!r})
import conftest
from hevcbench import cell
out = cell.run({tiny!r}, "tiny_shvc_batch", 2 ** 31 + 3, 0.3, True,
               device="cpu")
assert out["correct"], out
import run
print("FORBIDDEN", run.loaded_forbidden())
"""


def test_a_run_loads_no_jax(tiny_root):
    code = SNIPPET.format(root=tiny_root, bench=BENCH,
                          tests=os.path.join(BENCH, "tests"), tiny=tiny_root)
    cp = subprocess.run([sys.executable, "-c", code], capture_output=True,
                        text=True, timeout=600, cwd=tiny_root)
    assert cp.returncode == 0, cp.stderr[-3000:]
    assert "FORBIDDEN []" in cp.stdout


def test_without_the_program_a_run_fails_and_prints_no_result(tmp_path):
    import shutil
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    code = ("import sys; sys.path[:0] = ['.', 'benchmark']\n"
            "from hevcbench import cell\n"
            "print(cell.run('.', 'shvc_x2_batch', 1, 1.0, False, "
            "device='cpu'))\n")
    cp = subprocess.run([sys.executable, "-c", code], capture_output=True,
                        text=True, timeout=300, cwd=tmp_path)
    assert cp.returncode != 0
    assert cp.stdout == ""
    assert "openhevc_tpu_torch" in cp.stderr
    cp = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                         "shvc_x2_batch", "--seed", "1", "--seconds", "1"],
                        capture_output=True, text=True, timeout=300,
                        cwd=tmp_path)
    assert cp.returncode != 0 and cp.stdout == ""
