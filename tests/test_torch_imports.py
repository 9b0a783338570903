"""PyTorch port, import rule: ``sparkflow_tpu_torch`` imports torch and
never jax, nor anything of the JAX package ``sparkflow_tpu``. Checked in a
fresh interpreter (tests/conftest.py has already imported jax into this
one) and by scanning the port's import statements."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "sparkflow_tpu_torch")
SUBPACKAGES = ["sparkflow_tpu_torch", "sparkflow_tpu_torch.device",
               "sparkflow_tpu_torch.convert", "sparkflow_tpu_torch.models",
               "sparkflow_tpu_torch.ops", "sparkflow_tpu_torch.ops._build",
               "sparkflow_tpu_torch.serving", "sparkflow_tpu_torch.obs",
               "sparkflow_tpu_torch.resilience",
               "sparkflow_tpu_torch.utils.metrics",
               "sparkflow_tpu_torch.optimizers", "sparkflow_tpu_torch.core",
               "sparkflow_tpu_torch.trainer", "sparkflow_tpu_torch.compat",
               "sparkflow_tpu_torch.localml", "sparkflow_tpu_torch.graphdef",
               "sparkflow_tpu_torch.nn", "sparkflow_tpu_torch.graph_utils",
               "sparkflow_tpu_torch.ml_util",
               "sparkflow_tpu_torch.pipeline_util",
               "sparkflow_tpu_torch.spark_async",
               "sparkflow_tpu_torch.tensorflow_async",
               "sparkflow_tpu_torch.native", "sparkflow_tpu_torch.native.build",
               "sparkflow_tpu_torch.utils.preempt",
               "sparkflow_tpu_torch.utils.data",
               "sparkflow_tpu_torch.utils.text",
               "sparkflow_tpu_torch.utils.flops",
               "sparkflow_tpu_torch.resilience.driver",
               "sparkflow_tpu_torch.obs.stepstats",
               "sparkflow_tpu_torch.serving.policies",
               "sparkflow_tpu_torch.serving.membership",
               "sparkflow_tpu_torch.serving.router",
               "sparkflow_tpu_torch.serving.autoscaler",
               "sparkflow_tpu_torch.serving.coldstart",
               "sparkflow_tpu_torch.sim", "sparkflow_tpu_torch.sim.calibrate"]


def test_importing_the_port_loads_no_jax_and_no_jax_package():
    code = (
        "import importlib, json, sys\n"
        f"for m in {SUBPACKAGES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'sparkflow_tpu'\n"
        "             or m.startswith('sparkflow_tpu.'))\n"
        "print(json.dumps(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"


def _port_sources():
    for root, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, PORT))
def test_port_source_imports_neither_jax_nor_the_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:          # relative: stays inside the port
                continue
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "sparkflow_tpu"), (
                f"{os.path.relpath(path, REPO)}:{node.lineno} imports {n}")


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                else [node.module or ""] if isinstance(node, ast.ImportFrom)
                else [])
        for m in mods:
            assert m.split(".")[0] not in ("jax", "jaxlib", "sparkflow_tpu")


@pytest.mark.parametrize("name", ["dataplane.cpp", "tokenizer.cpp"])
def test_native_sources_are_the_jax_packages(name):
    """The host C++ of the data plane and the tokenizer is carried byte for
    byte; only the Python around it is rewired."""
    with open(os.path.join(PORT, "native", name), "rb") as f:
        ours = f.read()
    with open(os.path.join(REPO, "sparkflow_tpu", "native", name), "rb") as f:
        assert ours == f.read()
