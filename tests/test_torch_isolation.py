"""The port stands alone: no file of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the reference package, and the entry
points run on the card unless the caller asks for the CPU."""
import ast
import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.lineno, node.args[0].value


def test_port_files_exist():
    names = {p.name for p in PORT_FILES}
    assert {"chip_smoke.py", "ops.py", "engine.py", "scheduler.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [f"{path.name}:{line}: {mod}" for line, mod in _imports(path)
           if _forbidden(mod)]
    assert not bad, bad


def test_importing_the_port_loads_neither():
    code = ("import sys, repro_torch.serve, repro_torch.launch.serve, "
            "repro_torch.bridge, repro_torch.kernels.build, "
            "repro_torch.api, repro_torch.launch.train, repro_torch.comm, "
            "repro_torch.core.steps, repro_torch.core.fedavg, "
            "repro_torch.core.pipeline, repro_torch.core.fhdp, "
            "repro_torch.api.mesh, repro_torch.models.vision_encoder, "
            "repro_torch.train.loop, repro_torch.models.registry, "
            "repro_torch.sched.swift, repro_torch.sched.clustering, "
            "repro_torch.recovery.recover, repro_torch.recovery.failures, "
            "repro_torch.train.checkpoint, repro_torch.obs.trace, "
            "repro_torch.obs.validate, repro_torch.obs.profile, "
            "repro_torch.sched.mobility, repro_torch.sched.dwell, "
            "repro_torch.comm.events; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_default_to_the_card():
    from repro_torch.launch.serve import build_parser
    from repro_torch.models import lm
    from repro_torch.serve import (PagedEngine, int8_cache_fidelity,
                                   serve_continuous)
    from repro_torch.serve.kvcache import init_pools
    for fn in (serve_continuous, int8_cache_fidelity, PagedEngine.__init__,
               lm.init, lm.init_cache, init_pools):
        assert inspect.signature(fn).parameters["device"].default == "cuda", \
            fn.__qualname__
    args = build_parser().parse_args([])
    # the reference's launcher defaults to the legacy scheduler
    assert args.device == "cuda" and args.scheduler == "legacy"


def test_training_entry_points_default_to_the_card():
    from repro_torch.api import Session
    from repro_torch.comm.codecs import GeneratorBits
    from repro_torch.launch.train import build_parser
    from repro_torch.models import encdec, lm
    for fn in (Session.__init__, lm.init, GeneratorBits.__init__,
               encdec.init, encdec.init_cache):
        assert inspect.signature(fn).parameters["device"].default == "cuda", \
            fn.__qualname__
    args = build_parser().parse_args([])
    # the reference's launcher defaults: FHDP on flad-vision, mesh 2,4
    assert args.device == "cuda" and args.strategy == "pipeline"
    assert args.arch == "flad-vision" and args.mesh == "2,4"
