"""The Hopper kernels against their plain versions, on the card.

Marked ``gpu``: without a CUDA card they skip (decided inside a fixture).
The file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_card.py

Each kernel is called through its dispatch wrapper on CUDA tensors at the
shapes the 3C3D main path gives it at batch 128 (and at ragged shapes, for
every output mask), and held against its plain version on the same tensors.
A default ``run`` on CUDA tensors launches the kernels, and one
curvature-preconditioned training step agrees card against CPU.
"""
import itertools

import pytest
import torch

from repro_torch.configs import papernets
from repro_torch.core import CrossEntropyLoss, ExtensionConfig, by_name, run
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels import ops, ref
from repro_torch.optim import curvature_optimizer
from repro_torch.train import make_extended_train_step

FIRST_MASKS = [dict(want_l2=l2, want_moment=mo, want_dot=do)
               for l2, mo, do in itertools.product([False, True], repeat=3)
               if l2 or mo or do]
SECOND_MASKS = [dict(want_diag=d, want_kron=k, want_trace=t)
                for d, k, t in itertools.product([False, True], repeat=3)
                if d or k or t]

# (N, R, a, b) of the three conv layers at batch 128, and the dense shapes
# the rank-1 sq_matmul sees (moment, and DiagGGN on the C·N broadcast rows).
CONV = {"conv1": (128, 1024, 75, 64), "conv2": (128, 256, 576, 96),
        "conv3": (128, 64, 864, 128), "ragged": (200, 9, 70, 130)}
SQ = {"dense1": (128, 2048, 512), "dense1_diag": (1280, 2048, 512),
      "dense3_diag": (1280, 256, 10), "ragged": (37, 70, 130)}
CARD_TOL = 1e-4  # max |kernel − plain| / max |plain|: fp32, other sum order


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (see the module docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _card_close(kernel, plain):
    torch.cuda.synchronize()
    for k in plain:
        err = (kernel[k] - plain[k]).abs().max() / plain[k].abs().max()
        assert err.item() < CARD_TOL, (k, err.item())


@pytest.mark.gpu
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("layer", sorted(CONV))
def test_card_fused_first_order(cuda, layer, groups):
    n, r, a, b = CONV[layer]
    A = torch.randn(groups, n, r, a, device="cuda", generator=cuda)
    B = torch.randn(groups, n, r, b, device="cuda", generator=cuda)
    for mask in FIRST_MASKS:
        _card_close(ops.fused_first_order(A, B, **mask),
                    ref.fused_first_order(A, B, **mask))


@pytest.mark.gpu
@pytest.mark.parametrize("classes", [10, 1], ids=["exact", "mc"])
@pytest.mark.parametrize("layer", sorted(CONV))
def test_card_fused_second_order(cuda, layer, classes):
    n, r, a, b = CONV[layer]
    A = torch.randn(n, r, a, device="cuda", generator=cuda)
    S = torch.randn(classes, n, r, b, device="cuda", generator=cuda)
    for mask in SECOND_MASKS:
        _card_close(ops.fused_second_order(A, S, **mask),
                    ref.fused_second_order(A, S, **mask))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(SQ))
def test_card_sq_matmul(cuda, shape):
    n, a, b = SQ[shape]
    A = torch.randn(n, a, device="cuda", generator=cuda)
    B = torch.randn(n, b, device="cuda", generator=cuda)
    _card_close({"out": ops.sq_matmul(A, B)}, {"out": ref.sq_matmul(A, B)})


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 10], ids=["moment", "exact_broadcast"])
@pytest.mark.parametrize("layer", sorted(CONV))
def test_card_per_sample_moment(cuda, layer, rows):
    n, r, a, b = CONV[layer]
    A = torch.randn(rows * n, r, a, device="cuda", generator=cuda)
    B = torch.randn(rows * n, r, b, device="cuda", generator=cuda)
    _card_close({"out": ops.per_sample_moment(A, B)}, {"out": ref.per_sample_moment(A, B)})


@pytest.mark.gpu
@pytest.mark.parametrize("form", [None, "gram", "g"], ids=["auto", "gram", "g"])
@pytest.mark.parametrize("layer", sorted(CONV))
def test_card_batch_l2(cuda, layer, form):
    n, r, a, b = CONV[layer]
    A = torch.randn(n, r, a, device="cuda", generator=cuda)
    B = torch.randn(n, r, b, device="cuda", generator=cuda)
    _card_close({"out": ops.batch_l2(A, B, form)}, {"out": ref.batch_l2(A, B)})


@pytest.mark.gpu
@pytest.mark.parametrize("classes", [10, 1], ids=["exact", "mc"])
@pytest.mark.parametrize("layer", sorted(CONV))
def test_card_ggn_diag(cuda, layer, classes):
    n, r, a, b = CONV[layer]
    A = torch.randn(n, r, a, device="cuda", generator=cuda)
    S = torch.randn(classes, n, r, b, device="cuda", generator=cuda)
    _card_close({"out": ops.ggn_diag(A, S)}, {"out": ref.ggn_diag(A, S)})


# (C, N, R, a, b) of the Gram family's cross_dot calls at the conv layers.
GRAM_CONV = {k: (10,) + v for k, v in CONV.items() if k != "ragged"}


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["ntk", "ggn_gram", "two_row_sets"])
@pytest.mark.parametrize("layer", sorted(GRAM_CONV))
def test_card_cross_dot(cuda, layer, form):
    """The NTK's E = C groups over one shared input, GGNGram's C·N
    class-major rows (both one row set: the upper triangle), and two
    different row sets (two halves of the batch), each against the plain
    version on the explicit broadcast."""
    c, n, r, a, b = GRAM_CONV[layer]
    A = torch.randn(n, r, a, device="cuda", generator=cuda)
    S = torch.randn(c, n, r, b, device="cuda", generator=cuda)
    Afull = A[None].expand(c, n, r, a)
    if form == "ntk":
        got = ops.cross_dot(A[None], S, A[None], S)
        want = ref.cross_dot(Afull, S, Afull, S)
        torch.cuda.synchronize()
        assert torch.equal(got, got.transpose(1, 2))
    elif form == "ggn_gram":
        rows = S.reshape(1, c * n, r, b)
        got = ops.cross_dot(A[None], rows, A[None], rows)
        flat = Afull.reshape(1, c * n, r, a)
        want = ref.cross_dot(flat, rows, flat, rows)
        torch.cuda.synchronize()
        assert torch.equal(got, got.transpose(1, 2))
    else:
        h = n // 2
        A1, A2 = A[None, :h].contiguous(), A[None, h:].contiguous()
        B1, B2 = S[:1, :h].contiguous(), S[:1, h:].contiguous()
        got, want = ops.cross_dot(A1, B1, A2, B2), ref.cross_dot(A1, B1, A2, B2)
    _card_close({"out": got}, {"out": want})


@pytest.mark.gpu
@pytest.mark.parametrize("sigma", [True, False], ids=["diag", "kron"])
@pytest.mark.parametrize("layer", sorted(CONV))
def test_card_predictive_var(cuda, layer, sigma):
    n, r, a, b = CONV[layer]
    A = torch.randn(n, r, a, device="cuda", generator=cuda)
    S = torch.randn(10, n, r, b, device="cuda", generator=cuda)
    W = torch.rand(a, b, device="cuda", generator=cuda) if sigma else None
    _card_close({"out": ops.predictive_var(A, S, W)}, {"out": ref.predictive_var(A, S, W)})


def _c2d2(cuda):
    model = papernets.c2d2(img=16, device="cuda", generator=torch.Generator().manual_seed(0))
    x = torch.randn(16, 16, 16, 1, device="cuda", generator=cuda)
    y = torch.randint(0, 10, (16,), device="cuda", generator=cuda)
    return model, x, y


@pytest.mark.gpu
def test_card_default_run_launches_kernels(cuda):
    """No cfg: the port's default routes CUDA tensors through the kernels."""
    model, x, y = _c2d2(cuda)
    ops.reset_launch_counts()
    run(model, model.params(), x, y, CrossEntropyLoss(),
        extensions=(by_name("batch_l2"), by_name("diag_ggn")))
    counts = ops.launch_counts()
    assert counts["fused_first_order"] == 2 and counts["fused_second_order"] == 2
    assert counts["sq_matmul"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("use_fused", [True, False], ids=["fused", "per_extension"])
@pytest.mark.parametrize("curvature", ["kfac", "diag_ggn_mc"])
def test_card_train_step_matches_cpu(cuda, curvature, use_fused):
    model, x, y = _c2d2(cuda)
    opt = curvature_optimizer(0.1, damping=1.0, curvature=curvature)
    cfg = ExtensionConfig(use_kernels=True, use_fused=use_fused)
    step = make_extended_train_step(model, CrossEntropyLoss(), opt,
                                    (by_name(curvature), by_name("variance")), cfg,
                                    track=("variance",))
    draws = torch.randint(0, 10, (1, 16), generator=torch.Generator().manual_seed(1))
    params = model.params()
    card, _, m_card = step(params, opt.init(params), {"inputs": x, "labels": y}, 0, draws)
    cpu_params = tree_map(lambda p: p.cpu(), params)
    cpu, _, m_cpu = step(cpu_params, opt.init(cpu_params),
                         {"inputs": x.cpu(), "labels": y.cpu()}, 0, draws)
    torch.cuda.synchronize()
    assert abs(m_card["loss"].item() - m_cpu["loss"].item()) <= CARD_TOL * m_cpu["loss"].item()
    for a, b in zip(tree_leaves(card), tree_leaves(cpu), strict=True):
        assert ((a.cpu() - b).abs().max() / b.abs().max()).item() < CARD_TOL


@pytest.mark.gpu
def test_card_gram_and_laplace_paths_match_cpu(cuda):
    """NTK, NTKClasswise and GGNGram, then a Kronecker Laplace fit and its
    GLM predictive, on c2d2: card against CPU, each through its kernel."""
    from repro_torch.laplace import fit_posterior, glm_predictive

    model, x, y = _c2d2(cuda)
    params = model.params()
    cpu_params = tree_map(lambda p: p.cpu(), params)
    exts = (by_name("ntk"), by_name("ntk_classwise"), by_name("ggn_gram"))
    ops.reset_launch_counts()
    card = run(model, params, x, y, CrossEntropyLoss(), extensions=exts)
    assert ops.launch_counts()["cross_dot"] == 4
    cpu = run(model, cpu_params, x.cpu(), y.cpu(), CrossEntropyLoss(), extensions=exts)
    torch.cuda.synchronize()
    for e in exts:
        for a, b in zip(tree_leaves(card.ext[e.name]), tree_leaves(cpu.ext[e.name]), strict=True):
            assert ((a.cpu() - b).abs().max() / b.abs().max()).item() < CARD_TOL, e.name
    post = fit_posterior(model, params, x, y, CrossEntropyLoss(), structure="kron")
    ops.reset_launch_counts()
    mean, var = glm_predictive(model, params, post, x)
    assert ops.launch_counts()["predictive_var"] == 2
    cpu_post = fit_posterior(model, cpu_params, x.cpu(), y.cpu(), CrossEntropyLoss(),
                             structure="kron")
    _, cpu_var = glm_predictive(model, cpu_params, cpu_post, x.cpu())
    torch.cuda.synchronize()
    assert ((var.cpu() - cpu_var).abs().max() / cpu_var.abs().max()).item() < CARD_TOL
