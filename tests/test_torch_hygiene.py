"""The port stands alone: nothing under ``src/repro_torch/``, nor
``chip_smoke.py`` or ``chip_ab.py``, imports ``jax`` or any ``repro``
module (an AST scan of every import), and importing every module of the
port in a fresh interpreter loads no ``jax``."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _sources():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                          REPO / "chip_ab.py"]
    assert len(files) > 20 and all(f.exists() for f in files)
    names = {str(f.relative_to(PORT)) for f in files if PORT in f.parents}
    assert {"kernels/flash_attention.py", "kernels/paged_attention.py",
            "kernels/ops.py", "kernels/ref.py", "models/layers.py",
            "models/transformer.py", "models/registry.py", "launch/steps.py",
            "launch/serve.py", "serve/engine.py", "serve/kvcache.py",
            "core/quantize.py", "kernels/matmul.py",
            "kernels/quant_matmul.py", "models/resnet.py",
            "configs/resnet20_cifar.py", "data/cifar.py",
            "data/synthetic.py", "kernels/linear_scan.py", "models/ssm.py",
            "models/hybrid.py", "serve/metrics.py", "serve/workload.py",
            "serve/router.py", "serve/scheduler.py",
            "examples/serve_lm.py", "core/dataflow.py", "core/planner.py",
            "core/strategies.py", "core/perfmodel.py", "optim/adamw.py",
            "optim/schedules.py", "checkpoint/manager.py",
            "runtime/fault.py", "launch/train.py", "tree.py",
            "examples/train_resnet20_cifar.py", "examples/quickstart.py",
            "examples/quantize_ptq.py", "sharding/specs.py",
            "launch/mesh.py", "sharding/spmd.py", "sharding/pipeline.py",
            "optim/grad_compress.py", "runtime/elastic.py"} <= names
    return files


def _banned(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_no_jax_or_repro_imports_in_the_port():
    offenders = []
    for path in _sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            offenders += [f"{path.relative_to(REPO)}:{node.lineno} {n}"
                          for n in names if _banned(n)]
    assert not offenders, offenders


def test_importing_the_whole_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert int(proc.stdout.strip()) >= 20
