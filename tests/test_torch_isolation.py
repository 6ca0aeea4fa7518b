"""PyTorch port, isolation: the port and chip_smoke.py import neither jax
nor anything of the JAX package, and the engine never falls back to the
CPU on its own."""

import ast
import importlib
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import theroundtaible_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "theroundtaible_tpu_torch"


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib") or top == "theroundtaible_tpu"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imports(f) if _forbidden(m)]
    assert bad == []
    assert len(files) > 15


def test_importing_every_module_loads_neither():
    code = (
        "import importlib, pkgutil, sys\n"
        "import theroundtaible_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'theroundtaible_tpu')]\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 15


def test_every_module_imports_here():
    names = [m.name for m in pkgutil.walk_packages(
        theroundtaible_tpu_torch.__path__, "theroundtaible_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    assert "theroundtaible_tpu_torch.engine.kernels.attention" in names
    assert "theroundtaible_tpu_torch.engine.scheduler" in names
    # the pipeline modules (Queue 1 slice 3)
    assert "theroundtaible_tpu_torch.engine.pipeline" in names
    assert "theroundtaible_tpu_torch.engine.pp_serving" in names
    # sequence-parallel prefill (Queue 1 slice 4)
    assert "theroundtaible_tpu_torch.engine.longcontext" in names


def test_no_silent_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from theroundtaible_tpu_torch.engine import get_engine
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    config = {"model": "tiny-llama", "max_seq_len": 128}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine.from_config(config)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_engine(config)
    assert InferenceEngine.from_config(config, device="cpu").device.type \
        == "cpu"


def test_pipe_engine_has_no_silent_cpu_fallback():
    """A pipe mesh's engine asks for the card too, before any process
    group is touched."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from theroundtaible_tpu_torch.engine.pp_serving import PPEngine
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PPEngine.from_config({"model": "tiny-llama", "max_seq_len": 128,
                              "mesh": {"pipe": 2}})


def test_fleet_planner_has_no_silent_cpu_fallback():
    """The fleet planner's device queries (Queue 1 slice 5) read the card:
    without one they raise unless the caller asks for the CPU, where there
    is one device and no limit to check."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from theroundtaible_tpu_torch.engine import fleet
    cfgs = [{"model": "tiny-gemma"}, {"model": "tiny-llama"}]
    for call in (fleet.device_memory_bytes, fleet.device_count,
                 lambda: fleet.plan_fleet(cfgs)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert "devices" not in cfgs[0]
    fleet.plan_fleet(cfgs, device="cpu")
    assert cfgs[0]["devices"] == cfgs[1]["devices"] == [0]
