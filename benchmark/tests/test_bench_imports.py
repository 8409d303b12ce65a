"""Nothing the benchmark runs imports JAX or the JAX package, and the
yardstick (simulators, reference, work arithmetic, trace reading) imports
nothing of the port.  Top-level module names compare whole: the port's
name, falcon_unzip_tpu_torch, begins with the JAX package's."""
import ast
import glob
import os
import subprocess
import sys

import pytest

from benchmark import run

BENCH = os.path.join(run.ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "falcon_unzip_tpu"}
YARDSTICK = ["sim.py", "reference.py", "work.py", "trace.py", "readers.py"]


def imported(path: str) -> set:
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def harness_files() -> list:
    return [p for p in glob.glob(os.path.join(BENCH, "**", "*.py"),
                                 recursive=True)
            if os.sep + "tests" + os.sep not in p]


@pytest.mark.parametrize("path", harness_files(),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_import(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("name", YARDSTICK + ["metrics"])
def test_yardstick_imports_nothing_of_the_port(name):
    paths = (glob.glob(os.path.join(BENCH, name, "*.py"))
             if name == "metrics" else [os.path.join(BENCH, name)])
    for p in paths:
        assert "falcon_unzip_tpu_torch" not in imported(p), p


def test_no_jax_module_loaded_by_a_cell(tmp_path):
    """A whole tiny FalconSense run in a fresh interpreter: its slots, which
    load the port, report their modules and a run whose slot or parent
    holds JAX or the JAX package prints no result; then the parent's own
    sys.modules by top-level name."""
    code = (
        "import sys, json\n"
        "from benchmark import run, slots\n"
        "ov = {'config': {'length': 12000, 'read_len': 3000},\n"
        "      'traffic': {'slots': 1, 'scored': 1}}\n"
        "rc = run.main(['--workload', 'ecoli_20x.falconsense', '--seed',\n"
        "               '5', '--seconds', '0.1'], device='cpu',\n"
        "              overrides=ov)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    mods = set(__import__("json").loads(lines[-1]))
    assert not mods & FORBIDDEN
    assert '"correct"' in lines[-2]
