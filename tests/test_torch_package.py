"""Boundaries of the PyTorch/CUDA port.

* The port (``src/repro_torch``) and ``chip_smoke.py`` import neither JAX nor
  the JAX package ``repro``.
* ``import repro_torch`` and all its modules work with no nvcc and no
  triton: kernels are built and loaded only when they launch.
* A CUDA request without a card raises; nothing carries on on the CPU.
* ``chip_smoke.py`` fails without a card, and outside a checkout.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py"))


def _imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    assert not _imported(path) & {"jax", "jaxlib", "repro", "triton"}


def test_port_imports_without_nvcc_or_triton(tmp_path):
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = {'jax', 'repro', 'triton'} & set(sys.modules)\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cuda_request_without_card_raises(monkeypatch):
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import papernets

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        papernets.c3d3()
    model = papernets.logreg(in_dim=3, n_classes=2, device="cpu")
    arrays = ({"w": np.zeros((3, 2), np.float32), "b": np.zeros(2, np.float32)},)
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        params_from_numpy(model, arrays)


def test_kernel_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels.sq_matmul import sq_matmul_cuda

    with pytest.raises(ValueError, match="CUDA device"):
        sq_matmul_cuda(torch.zeros(4, 3), torch.zeros(4, 2))


def test_chip_smoke_fails_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs for real there")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
