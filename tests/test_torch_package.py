"""Boundaries of the PyTorch/CUDA port.

* The port (``src/repro_torch``) and ``chip_smoke.py`` import neither JAX nor
  the JAX package ``repro``.
* ``import repro_torch`` and all its modules work with no nvcc and no
  triton: kernels are built and loaded only when they launch.
* A CUDA request without a card raises; nothing carries on on the CPU.
* ``chip_smoke.py`` fails without a card, and outside a checkout.
* The examples and the serving and NTK-consumer launchers run with
  ``--device cpu`` (serving also with ``--uncertainty``), and ask for the
  card by default.
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


def test_boundary_covers_every_subpackage():
    for pkg in ("repro_torch.core", "repro_torch.kernels", "repro_torch.laplace",
                "repro_torch.curv", "repro_torch.optim", "repro_torch.train",
                "repro_torch.nn", "repro_torch.serve", "repro_torch.launch",
                "repro_torch.configs", "repro_torch.ntk_apps", "repro_torch.data"):
        assert pkg in MODULES
    for mod in ("repro_torch.nn.functional", "repro_torch.nn.blocks", "repro_torch.nn.wired",
                "repro_torch.nn.models", "repro_torch.serve.engine", "repro_torch.launch.serve",
                "repro_torch.configs.hymba_1_5b", "repro_torch.kernels.flash_attention",
                "repro_torch.kernels.wkv", "repro_torch.curv.products", "repro_torch.curv.cg",
                "repro_torch.curv.logdet", "repro_torch.curv.ngd",
                "repro_torch.ntk_apps.regression", "repro_torch.ntk_apps.influence",
                "repro_torch.ntk_apps.selection", "repro_torch.optim.matfree",
                "repro_torch.launch.ntk_apps", "repro_torch.data.synthetic",
                "repro_torch.train.loop", "repro_torch.launch.train",
                "repro_torch.examples.curvature_training", "repro_torch.examples.noise_scale",
                "repro_torch.examples.laplace_uncertainty"):
        assert mod in MODULES


KERNEL_NAMES = ["fused_first_order", "fused_second_order", "sq_matmul", "per_sample_moment",
                "batch_l2", "ggn_diag", "cross_dot", "predictive_var", "flash_attention", "wkv"]


def test_kernel_table_and_counters_agree():
    """Ten kernels, one per Pallas function of the JAX package: the dispatch
    table, the build list and the launch counters name the same ten."""
    from repro_torch.kernels import _build, ops

    assert list(ops.KERNELS) == KERNEL_NAMES
    assert tuple(_build.SOURCES) == ops.KERNELS
    assert set(ops.launch_counts()) == set(KERNEL_NAMES)
    pallas = sorted(p.stem for p in (ROOT / "src" / "repro" / "kernels").glob("*.py")
                    if "pl.pallas_call(" in p.read_text())
    assert pallas == sorted(KERNEL_NAMES)


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_every_kernel_is_wired(name):
    """Each of the ten kernels: a dispatch entry with its own launch
    counter, a plain version, a wrapper module naming its CUDA source (built
    by ``_build``) and the Pallas kernel it replaces, and no JAX import."""
    import importlib

    from repro_torch.kernels import _build, ops, ref

    assert name in ops.KERNELS and name in ops.launch_counts()
    assert callable(getattr(ops, name)) and callable(getattr(ref, name))
    wrapper = importlib.import_module(f"repro_torch.kernels.{name}")
    assert (ROOT / wrapper.SOURCE).is_file() and name in _build.SOURCES
    path, line = wrapper.REPLACES.split(":")
    assert "pl.pallas_call" in (ROOT / path).read_text()
    assert "def " in (ROOT / path).read_text().splitlines()[int(line) - 1]
    assert not _imported(ROOT / "src" / "repro_torch" / "kernels" / f"{name}.py") & {
        "jax", "jaxlib", "repro", "triton"}


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


@pytest.mark.parametrize("name,expect", [("quickstart", "ONE extended backward pass"),
                                         ("per_sample_clipping", "clipped fraction")])
def test_examples_run_on_cpu(name, expect):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{name}",
                           "--device", "cpu"], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert expect in proc.stdout


def test_example_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the example runs on it")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.examples.quickstart"],
                          env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA device was requested" in proc.stderr


def test_serve_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                           "hymba-1.5b", "--device", "cpu", "--max-len", "24"],
                          env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "generated (4, 24) tokens on cpu" in proc.stdout


def test_serve_launcher_asks_for_the_card_by_default(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        serve.main(["--arch", "hymba-1.5b"])
    mean, var = serve.main(["--arch", "hymba-1.5b", "--device", "cpu", "--uncertainty"])
    assert tuple(mean.shape) == tuple(var.shape) == (4, 97) and (var >= 0).all()


def test_ntk_apps_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.ntk_apps", "--gp",
                           "--device", "cpu", "--n-train", "24", "--n-test", "6"],
                          env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "[gp] on cpu: solver=cholesky" in proc.stdout


def test_ntk_apps_launcher_asks_for_the_card_by_default(monkeypatch):
    from repro_torch.launch import ntk_apps

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        ntk_apps.main(["--gp"])
