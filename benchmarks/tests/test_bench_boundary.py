"""What a run may load: after a CPU rehearsal of the harness's import
graph (a tiny cell run through `harness.run_cell`), no module whose
top-level name is `jax`, `jaxlib`, `flax` or `dpig_tpu` (compared whole:
`dpig_tpu_torch` is the program); and the plain reference imports nothing
of the program."""
import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

from benchmarks import spec

HERE = pathlib.Path(spec.HERE)
REHEARSAL = """
import json, sys, time
sys.path.insert(0, {tests!r})
from conftest import tiny
from benchmarks import harness, spec
import benchmarks.run
for name in {cells!r}:
    cell = tiny(spec.load_cell(name))
    for m in cell.per_layer:
        spec.reader(m["name"])
    harness.run_cell(cell, 5, 0.5, False, "cpu", time.perf_counter())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_rehearsal_loads_no_jax():
    code = REHEARSAL.format(tests=str(HERE / "tests"),
                            cells=["market.train.b16", "market.transfer.b32"])
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    roots = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "dpig_tpu_torch" in roots and "torch" in roots
    assert not roots & set(spec.FORBIDDEN_MODULES)


def test_forbidden_names_are_compared_whole():
    assert spec.forbidden_loaded(["dpig_tpu_torch.apps", "jaxtyping",
                                  "torch"]) == []
    assert spec.forbidden_loaded(["dpig_tpu.apps", "jax.numpy", "flax",
                                  "jaxlib.xla"]) == ["dpig_tpu", "flax",
                                                     "jax", "jaxlib"]


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        roots = set(_imports(path))
        assert not roots & {"dpig_tpu_torch", *spec.FORBIDDEN_MODULES}, path


def test_no_benchmark_file_imports_jax():
    for path in HERE.rglob("*.py"):
        assert not set(_imports(path)) & set(spec.FORBIDDEN_MODULES), path


def _run(cwd):
    return subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload",
         "market.train.b16", "--seed", "3", "--seconds", "1", "--trace",
         "0"], cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    out = _run(spec.ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert "No module named 'dpig_tpu_torch'" in out.stderr
