"""The Hopper kernels against their plain versions, on the card.

Marked ``gpu``: without a CUDA card they skip (decided inside a fixture).
The file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_card.py

Each kernel is called through its dispatch wrapper on CUDA tensors at the
shapes the 3C3D main path gives it at batch 128 (and at ragged shapes, for
every output mask), and held against its plain version on the same tensors.
"""
import itertools

import pytest
import torch

from repro_torch.kernels import ops, ref

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
