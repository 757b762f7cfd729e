"""The Hopper kernels against their plain versions, on the card.

Marked ``gpu``: without a CUDA card they skip (decided inside a fixture).
The file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_card.py

Each kernel is called through its dispatch wrapper on CUDA tensors at the
shapes the 3C3D main path gives it at batch 128 (and at ragged shapes, for
every output mask), and held against its plain version on the same tensors.
A default ``run`` on CUDA tensors launches the kernels, and one
curvature-preconditioned training step agrees card against CPU.  The
language models' two kernels, ``flash_attention`` and ``wkv``, are held in
float32 and bfloat16, with a fully masked row, T = 1 decode against ring and
global caches, ragged tiles and chunks, and Hymba's [N, T, H, 1] decay;
flash_attention's tensor-core design ("wgmma") at g = 5 and 1, dh 64 and
128, with and without a causal mask and a window, and at the configs' wider
heads in bf16 (120, 192 with dv 128, 240: T < S, rows off the block, a
window of 1, the same bits from call to call), its CUDA-core design at
those heads in float32, and its
split-KV design ("split", T·g < 64) at Hymba-1.5B's full decode shapes, a
fully masked row, S off the splits, dh 128 and 256 and short prompts, the
same bits from call to call; wkv also at
Hymba's full prefill width and at a dv off its column slice, held row by
row in bf16; sq_matmul's and wkv's calls give the same bits from call to
call; the reduced Hymba serves on the card as on the CPU.  The 3xTF32
kernels, cross_dot, fused_second_order, fused_first_order,
per_sample_moment, predictive_var and ggn_diag, and batch_l2 in both its forms, are
also held to their formula in float64
(``chip_smoke.F64_TOL`` whole-tensor, ``ENTRY_TOL`` entry by entry), off the
3C3D shapes too (shared, per-group and fewer-row A sides, C = 1, 3, 10 and
13, E = 1 and 3 groups, N = 1 to 1280 rows, R = 1, widths and rows off the
tiles, conv3's widths at 256 and 1024 rows a sample), and give the same bits
from call to call; so is sq_matmul.
"""
import itertools
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import ENTRY_TOL, F64_TOL, f64_readings  # noqa: E402
from repro_torch.configs import papernets
from repro_torch.core import CrossEntropyLoss, ExtensionConfig, by_name, run
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels import ops, ref
from repro_torch.kernels.batch_l2 import batch_l2_form
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


def _f64_close(name, kernel, exact):
    """A kernel against its formula in float64: chip_smoke.py's
    whole-tensor and entry-by-entry limits."""
    torch.cuda.synchronize()
    r = f64_readings(torch, name, kernel, exact)
    assert r["rel64"] <= F64_TOL and r["entry_median"] <= ENTRY_TOL, r


@pytest.mark.gpu
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("layer", sorted(CONV))
def test_card_fused_first_order(cuda, layer, groups):
    n, r, a, b = CONV[layer]
    A = torch.randn(groups, n, r, a, device="cuda", generator=cuda)
    B = torch.randn(groups, n, r, b, device="cuda", generator=cuda)
    for mask in FIRST_MASKS:
        got = ops.fused_first_order(A, B, **mask)
        _card_close(got, ref.fused_first_order(A, B, **mask))
        _f64_close("fused_first_order", got,
                   ref.fused_first_order(A, B, **mask, dtype=torch.float64))


@pytest.mark.gpu
@pytest.mark.parametrize("classes", [10, 1], ids=["exact", "mc"])
@pytest.mark.parametrize("layer", sorted(CONV))
def test_card_fused_second_order(cuda, layer, classes):
    n, r, a, b = CONV[layer]
    A = torch.randn(n, r, a, device="cuda", generator=cuda)
    S = torch.randn(classes, n, r, b, device="cuda", generator=cuda)
    for mask in SECOND_MASKS:
        got = ops.fused_second_order(A, S, **mask)
        _card_close(got, ref.fused_second_order(A, S, **mask))
        _f64_close("fused_second_order", got,
                   ref.fused_second_order(A, S, **mask, dtype=torch.float64))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(SQ))
def test_card_sq_matmul(cuda, shape):
    n, a, b = SQ[shape]
    A = torch.randn(n, a, device="cuda", generator=cuda)
    B = torch.randn(n, b, device="cuda", generator=cuda)
    got = {"out": ops.sq_matmul(A, B)}
    _card_close(got, {"out": ref.sq_matmul(A, B)})
    _f64_close("sq_matmul", got, {"out": ref.sq_matmul(A, B, dtype=torch.float64)})


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 10], ids=["moment", "exact_broadcast"])
@pytest.mark.parametrize("layer", sorted(CONV))
def test_card_per_sample_moment(cuda, layer, rows):
    n, r, a, b = CONV[layer]
    A = torch.randn(rows * n, r, a, device="cuda", generator=cuda)
    B = torch.randn(rows * n, r, b, device="cuda", generator=cuda)
    got = {"out": ops.per_sample_moment(A, B)}
    _card_close(got, {"out": ref.per_sample_moment(A, B)})
    _f64_close("per_sample_moment", got,
               {"out": ref.per_sample_moment(A, B, dtype=torch.float64)})


# fused_first_order off the 3C3D shapes: (R, a, b) at rows N and groups E.
FIRST_WIDTHS = {"r1_a75_b64": (1, 75, 64), "r3_a75_b64": (3, 75, 64),
                "r1_a13_b7": (1, 13, 7), "r3_a13_b7": (3, 13, 7)}


@pytest.mark.gpu
@pytest.mark.parametrize("width", sorted(FIRST_WIDTHS))
@pytest.mark.parametrize("n", [1, 100, 200])
@pytest.mark.parametrize("groups", [1, 3])
def test_card_fused_first_order_cases(cuda, groups, n, width):
    """Every output mask at E = 1 and 3, N = 1, 100 and 200 (one and two
    Gram tiles), R = 1 and 3, widths off the tiles: float32 and float64
    agreement, dot symmetric bit for bit, l2 equal to dot's diagonal bit for
    bit (it is read from there), and the same bits from call to call."""
    r, a, b = FIRST_WIDTHS[width]
    A = torch.randn(groups, n, r, a, device="cuda", generator=cuda)
    B = torch.randn(groups, n, r, b, device="cuda", generator=cuda)
    for mask in FIRST_MASKS:
        got = ops.fused_first_order(A, B, **mask)
        _card_close(got, ref.fused_first_order(A, B, **mask))
        _f64_close("fused_first_order", got,
                   ref.fused_first_order(A, B, **mask, dtype=torch.float64))
        if mask["want_dot"]:
            assert torch.equal(got["dot"], got["dot"].transpose(1, 2))
        if mask["want_dot"] and mask["want_l2"]:
            assert torch.equal(got["l2"], torch.diagonal(got["dot"], dim1=1, dim2=2))
        again = ops.fused_first_order(A, B, **mask)
        assert all(torch.equal(got[k], again[k]) for k in got)


# per_sample_moment off the 3C3D shapes: (rows, R, a, b).
MOMENT = {"rows1_ragged": (1, 3, 13, 7), "rows129_ragged": (129, 9, 70, 130),
          "rows1280_a75": (1280, 16, 75, 64), "rows129_r1": (129, 1, 75, 64)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(MOMENT))
def test_card_per_sample_moment_cases(cuda, case):
    """Rows of 1, 129 and 1280, R = 1 and widths off the tiles: float32 and
    float64 agreement, and the same bits from call to call."""
    rows, r, a, b = MOMENT[case]
    A = torch.randn(rows, r, a, device="cuda", generator=cuda)
    B = torch.randn(rows, r, b, device="cuda", generator=cuda)
    got = ops.per_sample_moment(A, B)
    _card_close({"out": got}, {"out": ref.per_sample_moment(A, B)})
    _f64_close("per_sample_moment", {"out": got},
               {"out": ref.per_sample_moment(A, B, dtype=torch.float64)})
    assert torch.equal(got, ops.per_sample_moment(A, B))


@pytest.mark.gpu
@pytest.mark.parametrize("form", [None, "gram", "g"], ids=["auto", "gram", "g"])
@pytest.mark.parametrize("layer", sorted(CONV))
def test_card_batch_l2(cuda, layer, form):
    n, r, a, b = CONV[layer]
    A = torch.randn(n, r, a, device="cuda", generator=cuda)
    B = torch.randn(n, r, b, device="cuda", generator=cuda)
    got = {"out": ops.batch_l2(A, B, form)}
    _card_close(got, {"out": ref.batch_l2(A, B)})
    _f64_close("batch_l2", got, {"out": ref.batch_l2(A, B, dtype=torch.float64)})
    if (form or batch_l2_form(r, a, b)) == "g":  # fused_first_order's l2-only launch
        l2 = ops.fused_first_order(A[None], B[None], want_l2=True, want_moment=False,
                                   want_dot=False)["l2"][0]
        assert torch.equal(got["out"], l2)


@pytest.mark.gpu
@pytest.mark.parametrize("classes", [10, 1], ids=["exact", "mc"])
@pytest.mark.parametrize("layer", sorted(CONV))
def test_card_ggn_diag(cuda, layer, classes):
    n, r, a, b = CONV[layer]
    A = torch.randn(n, r, a, device="cuda", generator=cuda)
    S = torch.randn(classes, n, r, b, device="cuda", generator=cuda)
    got = {"out": ops.ggn_diag(A, S)}
    _card_close(got, {"out": ref.ggn_diag(A, S)})
    _f64_close("ggn_diag", got, {"out": ref.ggn_diag(A, S, dtype=torch.float64)})


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
        full = (Afull, S, Afull, S)
        torch.cuda.synchronize()
        assert torch.equal(got, got.transpose(1, 2))
    elif form == "ggn_gram":
        rows = S.reshape(1, c * n, r, b)
        got = ops.cross_dot(A[None], rows, A[None], rows)
        flat = Afull.reshape(1, c * n, r, a)
        full = (flat, rows, flat, rows)
        torch.cuda.synchronize()
        assert torch.equal(got, got.transpose(1, 2))
    else:
        h = n // 2
        A1, A2 = A[None, :h].contiguous(), A[None, h:].contiguous()
        B1, B2 = S[:1, :h].contiguous(), S[:1, h:].contiguous()
        got, full = ops.cross_dot(A1, B1, A2, B2), (A1, B1, A2, B2)
    _card_close({"out": got}, {"out": ref.cross_dot(*full)})
    _f64_close("cross_dot", {"out": got}, {"out": ref.cross_dot(*full, dtype=torch.float64)})


# cross_dot off the 3C3D shapes: (E, N1, N2 or None for one row set, R, a,
# b, rows of A (a_rows; N1 when the rows pair one to one), A per group).
CROSS = {
    "a75_e10_shared_a": (10, 128, None, 32, 75, 64, 128, False),
    "n127_off_tile_widths": (1, 127, None, 9, 70, 130, 127, False),
    "e1_a_rows_below_n": (1, 160, None, 16, 36, 40, 40, False),
    "e10_a_per_group": (10, 64, None, 16, 50, 24, 64, True),
    "two_row_sets_ragged": (2, 50, 77, 12, 33, 20, 50, False),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CROSS))
def test_card_cross_dot_cases(cuda, case):
    """Shared, per-group and fewer-row A sides, one row set (symmetric bit
    for bit) and two, widths and rows off the tiles: float32 and float64
    agreement, and the same bits from call to call."""
    e, n1, n2, r, a, b, a_rows, per_group = CROSS[case]

    def side(n, rows):
        A = torch.randn(e if per_group else 1, rows, r, a, device="cuda", generator=cuda)
        return A, torch.randn(e, n, r, b, device="cuda", generator=cuda)

    A1, B1 = side(n1, a_rows)
    A2, B2 = (A1, B1) if n2 is None else side(n2, n2)
    got = ops.cross_dot(A1, B1, A2, B2)
    full = (ops.full_a_side(A1, B1), B1, ops.full_a_side(A2, B2), B2)
    _card_close({"out": got}, {"out": ref.cross_dot(*full)})
    _f64_close("cross_dot", {"out": got}, {"out": ref.cross_dot(*full, dtype=torch.float64)})
    assert torch.equal(got, ops.cross_dot(A1, B1, A2, B2))
    if n2 is None:
        assert torch.equal(got, got.transpose(1, 2))


# fused_second_order off the 3C3D shapes: (C, N, R, a, b).
SECOND = {
    "a75_exact": (10, 128, 64, 75, 64),
    "n127_off_tile_widths": (10, 127, 9, 70, 130),
    "mc_c1_ragged": (1, 127, 9, 70, 130),
    "c3_part_of_a_class_block": (3, 40, 16, 50, 36),
    "c13_two_class_blocks": (13, 24, 16, 40, 72),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SECOND))
def test_card_fused_second_order_cases(cuda, case):
    """Every output mask (kron alone is KFAC's call) at classes C = 1, 3, 10
    and 13 and widths and rows off the tiles: float32 and float64
    agreement, and the same bits from call to call."""
    c, n, r, a, b = SECOND[case]
    A = torch.randn(n, r, a, device="cuda", generator=cuda)
    S = torch.randn(c, n, r, b, device="cuda", generator=cuda)
    for mask in SECOND_MASKS:
        got = ops.fused_second_order(A, S, **mask)
        _card_close(got, ref.fused_second_order(A, S, **mask))
        _f64_close("fused_second_order", got,
                   ref.fused_second_order(A, S, **mask, dtype=torch.float64))
        again = ops.fused_second_order(A, S, **mask)
        assert all(torch.equal(got[k], again[k]) for k in got)


@pytest.mark.gpu
@pytest.mark.parametrize("sigma", [True, False], ids=["diag", "kron"])
@pytest.mark.parametrize("layer", sorted(CONV))
def test_card_predictive_var(cuda, layer, sigma):
    n, r, a, b = CONV[layer]
    A = torch.randn(n, r, a, device="cuda", generator=cuda)
    S = torch.randn(10, n, r, b, device="cuda", generator=cuda)
    W = torch.rand(a, b, device="cuda", generator=cuda) if sigma else None
    got = {"out": ops.predictive_var(A, S, W)}
    _card_close(got, {"out": ref.predictive_var(A, S, W)})
    _f64_close("predictive_var", got,
               {"out": ref.predictive_var(A, S, W, dtype=torch.float64)})


@pytest.mark.gpu
@pytest.mark.parametrize("sigma", [True, False], ids=["diag", "kron"])
@pytest.mark.parametrize("case", sorted(SECOND))
def test_card_predictive_var_cases(cuda, case, sigma):
    """Classes C = 1 (the warpgroups split the a-columns), 3, 10 and 13 (two
    class blocks), widths and rows off the tiles: float32 and float64
    agreement, and the same bits from call to call."""
    c, n, r, a, b = SECOND[case]
    A = torch.randn(n, r, a, device="cuda", generator=cuda)
    S = torch.randn(c, n, r, b, device="cuda", generator=cuda)
    W = torch.rand(a, b, device="cuda", generator=cuda) if sigma else None
    got = ops.predictive_var(A, S, W)
    _card_close({"out": got}, {"out": ref.predictive_var(A, S, W)})
    _f64_close("predictive_var", {"out": got},
               {"out": ref.predictive_var(A, S, W, dtype=torch.float64)})
    assert torch.equal(got, ops.predictive_var(A, S, W))


# conv3's widths (a = 864, b = 128) at 256 and 1024 rows a sample, N = 128:
# deep enough that a sum carried through a sample's rows in the tensor
# cores' accumulator, unpromoted, fails the float64 checks
# (tools/cross_dot_fault.py); conv3 itself has 64 rows.
CONV3_DEEP = {"conv3_r256": (128, 256, 864, 128), "conv3_r1024": (128, 1024, 864, 128)}


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["cross_dot", "fused_first_order", "per_sample_moment",
                                    "predictive_var", "ggn_diag"])
@pytest.mark.parametrize("case", sorted(CONV3_DEEP))
def test_card_conv3_widths_deep_rows(cuda, case, kernel):
    n, r, a, b = CONV3_DEEP[case]
    A = torch.randn(n, r, a, device="cuda", generator=cuda)
    if kernel == "cross_dot":  # the NTK's ten groups over one shared input
        S = torch.randn(10, n, r, b, device="cuda", generator=cuda)
        got = {"out": ops.cross_dot(A[None], S, A[None], S)}
        full = (ops.full_a_side(A[None], S), S, ops.full_a_side(A[None], S), S)
        want, want64 = ref.cross_dot(*full), ref.cross_dot(*full, dtype=torch.float64)
    elif kernel == "fused_first_order":
        B = torch.randn(1, n, r, b, device="cuda", generator=cuda)
        mask = dict(want_l2=True, want_moment=True, want_dot=True)
        got = ops.fused_first_order(A[None], B, **mask)
        want = ref.fused_first_order(A[None], B, **mask)
        want64 = ref.fused_first_order(A[None], B, **mask, dtype=torch.float64)
    elif kernel == "per_sample_moment":
        B = torch.randn(n, r, b, device="cuda", generator=cuda)
        got = {"out": ops.per_sample_moment(A, B)}
        want, want64 = (ref.per_sample_moment(A, B, dtype=d) for d in (torch.float32, torch.float64))
    elif kernel == "ggn_diag":
        S = torch.randn(10, n, r, b, device="cuda", generator=cuda)
        got = {"out": ops.ggn_diag(A, S)}
        want, want64 = (ref.ggn_diag(A, S, dtype=d) for d in (torch.float32, torch.float64))
    else:
        S = torch.randn(10, n, r, b, device="cuda", generator=cuda)
        W = torch.rand(a, b, device="cuda", generator=cuda)
        got = {"out": ops.predictive_var(A, S, W)}
        want, want64 = (ref.predictive_var(A, S, W, dtype=d) for d in (torch.float32, torch.float64))
    want, want64 = (w if isinstance(w, dict) else {"out": w} for w in (want, want64))
    _card_close(got, want)
    _f64_close(kernel, got, want64)


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


# -- attention and WKV (the language models' serving path) --------------------
# bf16 in and out: the kernel and the plain version both compute in float32
# and round once to bfloat16; a float32 difference in the last place can flip
# that rounding, so the limit is one bfloat16 step of the largest output (2^-7).
BF16_TOL = 1e-2
ATTN = {  # (N, T, S, H, KV, dh, window, positions)
    "prefill_g5": (2, 130, 130, 10, 2, 64, None, None),
    "window_ragged": (2, 77, 77, 6, 3, 16, 20, None),
    "noncausal": (1, 33, 70, 4, 4, 32, None, "noncausal"),
    "decode_ring": (3, 1, 64, 10, 2, 64, 64, "ring"),
    "decode_global": (3, 1, 100, 10, 2, 64, None, "global"),
    "all_masked": (2, 3, 40, 4, 2, 16, None, "empty"),
    "all_masked_many_rows": (1, 40, 40, 4, 2, 16, None, "empty"),
}


def _attn_inputs(case, dtype, gen):
    n, t, s, h, kv, dh, window, pos = ATTN[case]
    q = torch.randn(n, t, h, dh, device="cuda", generator=gen).to(dtype)
    k = torch.randn(n, s, kv, dh, device="cuda", generator=gen).to(dtype)
    v = torch.randn(n, s, kv, dh, device="cuda", generator=gen).to(dtype)
    kw = dict(window=window)
    i32 = dict(device="cuda", dtype=torch.int32)
    if pos == "noncausal":
        kw["causal"] = False
    elif pos == "ring":  # position 150 in a ring of 64: wrapped twice, one slot empty
        kp = torch.arange(s, **i32) + 128
        kp[s - 41:] -= 64
        kp[5] = -1
        kw.update(q_positions=torch.tensor([150], **i32), k_positions=kp)
    elif pos == "global":  # a cache of 100 holding positions 0..60
        kp = torch.arange(s, **i32)
        kp[61:] = -1
        kw.update(q_positions=torch.tensor([60], **i32), k_positions=kp)
    elif pos == "empty":  # no slot written: the uniform average of all values
        kw.update(q_positions=torch.arange(t, **i32), k_positions=torch.full((s,), -1, **i32))
    return q, k, v, kw


def _rel(a, b):
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


# Row by row for bf16 attention: the whole tensor's max |b| comes from the
# first rows (few keys seen), ~10× a late row's outputs; this limit is two
# and a half bfloat16 steps of each row's largest output (as chip_smoke.py).
ROW_TOL = 2e-2


def _row_rel(a, b):
    a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
    return ((a - b).abs().amax(-1) / b.abs().amax(-1)).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(ATTN))
def test_card_flash_attention(cuda, case, dtype):
    """Rows of T·g < 64 take the split-KV design (decode, the first
    all-masked case), others the CUDA-core one."""
    q, k, v, kw = _attn_inputs(case, dtype, cuda)
    want = ref.flash_attention(q, k, v, **kw)
    tol = CARD_TOL if dtype == torch.float32 else BF16_TOL
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == want.shape
    assert _rel(got, want) < tol
    if kw.get("k_positions") is not None and (kw["k_positions"] < 0).all():
        mean = v.float().mean(1, keepdim=True).repeat_interleave(q.shape[2] // k.shape[2], 2)
        assert _rel(got, mean.expand_as(got)) < tol


@pytest.mark.gpu
def test_card_flash_attention_bf16_queries_fp32_cache(cuda):
    """Decode reads a float32 KV cache with the bfloat16 model's queries."""
    q, k, v, kw = _attn_inputs("decode_ring", torch.float32, cuda)
    q = q.to(torch.bfloat16)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, **kw)
    assert ops.launch_counts()["flash_attention"] == 1 and got.dtype == torch.bfloat16
    assert _rel(got, ref.flash_attention(q, k, v, **kw)) < BF16_TOL


# The "wgmma" design (bf16 prefill on the tensor cores): GQA (g = 5) and
# none (g = 1), dh 64 and 128, causal with no window and with 1024, not
# causal with and without a window, T·g and T not multiples of the tiles.
TC_ATTN = {  # (N, T, S, H, KV, dh, causal, window)
    "g5_dh64_causal": (2, 200, 200, 10, 2, 64, True, None),
    "g5_dh64_window1024": (1, 1100, 1100, 10, 2, 64, True, 1024),
    "g1_dh64_causal": (2, 130, 130, 4, 4, 64, True, None),
    "g5_dh128_causal": (1, 150, 150, 10, 2, 128, True, None),
    "g1_dh128_window1024": (1, 1090, 1090, 2, 2, 128, True, 1024),
    "g5_dh64_noncausal": (1, 70, 90, 10, 2, 64, False, None),
    "g1_dh128_noncausal_window": (1, 70, 90, 4, 4, 128, False, 30),
    "g5_dh64_ragged_window": (2, 77, 77, 10, 2, 64, True, 20),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(TC_ATTN))
def test_card_flash_attention_wgmma(cuda, case):
    from repro_torch.kernels.flash_attention import design

    n, t, s, h, kv, dh, causal, window = TC_ATTN[case]
    q = torch.randn(n, t, h, dh, device="cuda", generator=cuda).bfloat16()
    k = torch.randn(n, s, kv, dh, device="cuda", generator=cuda).bfloat16()
    v = torch.randn(n, s, kv, dh, device="cuda", generator=cuda).bfloat16()
    assert design(q, k, v, window) == "wgmma"
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _rel(got, want) < BF16_TOL
    assert _row_rel(got, want) < ROW_TOL


# The head widths of the configs: dh 120 with a window (h2o-danube3), 128
# (codeqwen1.5, internvl2), 192 with dv 128 (MLA), 240 with GQA (gemma3);
# prefill with rows off the block ("wgmma" in bf16, "simt" in float32), and
# decode against a cache with positions ("split": bf16 queries against a
# float32 cache).
WIDE_ATTN = {  # (H, KV, dh, dv, window)
    "dh120_window": (8, 2, 120, 120, 16),
    "dh128": (8, 2, 128, 128, None),
    "dh192_dv128": (4, 4, 192, 128, None),
    "dh240_gqa": (8, 4, 240, 240, 32),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("width", sorted(WIDE_ATTN))
def test_card_flash_attention_wide(cuda, width, mode, dtype):
    from repro_torch.kernels.flash_attention import design

    h, kv, dh, dv, window = WIDE_ATTN[width]
    n, s = 2, 150
    t = s if mode == "prefill" else 1
    cache = dtype if mode == "prefill" else torch.float32
    q = torch.randn(n, t, h, dh, device="cuda", generator=cuda).to(dtype)
    k = torch.randn(n, s, kv, dh, device="cuda", generator=cuda).to(cache)
    v = torch.randn(n, s, kv, dv, device="cuda", generator=cuda).to(cache)
    kw = dict(window=window)
    if mode == "decode":  # a cache of 150 holding positions 0..120
        kp = torch.arange(s, device="cuda", dtype=torch.int32)
        kp[121:] = -1
        kw.update(q_positions=torch.tensor([120], device="cuda", dtype=torch.int32),
                  k_positions=kp)
    want_design = ("split" if mode == "decode" else
                   "wgmma" if dtype == torch.bfloat16 else "simt")
    assert design(q, k, v, kw["window"], kw.get("q_positions"),
                  kw.get("k_positions")) == want_design
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    want = ref.flash_attention(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == want.shape == (n, t, h, dv)
    assert _rel(got, want) < (CARD_TOL if dtype == torch.float32 else BF16_TOL)
    if dtype == torch.bfloat16:
        assert _row_rel(got, want) < ROW_TOL


# The "wgmma" design's wide instances, (128, 128) for dh 120, (192, 128) for
# MLA, (256, 256) for dh 240: T < S, rows a KV head off the 128-row block,
# a window of 1 (each row sees its own key alone: its own value), not
# causal; two calls give the same bits.
WIDE_TC_ATTN = {  # (N, T, S, H, KV, dh, dv, causal, window)
    "dh120_t_below_s": (1, 100, 170, 8, 2, 120, 120, True, None),
    "dh120_window1": (2, 70, 70, 8, 2, 120, 120, True, 1),
    "mla_rows_off_block": (1, 77, 77, 16, 16, 192, 128, True, None),
    "mla_t_below_s_window": (1, 90, 200, 4, 4, 192, 128, True, 50),
    "mla_noncausal": (1, 70, 90, 2, 2, 192, 128, False, None),
    "dh240_window1": (1, 64, 64, 4, 2, 240, 240, True, 1),
    "dh240_t_below_s_window": (1, 100, 300, 8, 4, 240, 240, True, 64),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(WIDE_TC_ATTN))
def test_card_flash_attention_wide_wgmma(cuda, case):
    from repro_torch.kernels.flash_attention import design

    n, t, s, h, kv, dh, dv, causal, window = WIDE_TC_ATTN[case]
    q = torch.randn(n, t, h, dh, device="cuda", generator=cuda).bfloat16()
    k = torch.randn(n, s, kv, dh, device="cuda", generator=cuda).bfloat16()
    v = torch.randn(n, s, kv, dv, device="cuda", generator=cuda).bfloat16()
    assert design(q, k, v, window) == "wgmma"
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    again = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 2
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (n, t, h, dv)
    assert _rel(got, want) < BF16_TOL
    assert _row_rel(got, want) < ROW_TOL
    assert torch.equal(got, again)
    if window == 1:  # row t sees key t alone
        own = v[:, :t].repeat_interleave(h // kv, 2)
        assert torch.equal(got, own)


# The "split" design (T·g < 64 rows a KV head): Hymba-1.5B's decode at full
# size, bf16 queries against its float32 caches at position 1500 (a ring of
# 1024 that wrapped, a global cache of 2048 with the slots past 1500 empty),
# a decode row with no slot written (the mean of all values), S off the
# splits (1000, 150), the wide decode heads (dh 128 without GQA, 256 with a
# ring), float32 and bf16 caches, and short prompts (T·g = 60 and 63: row
# groups of 8, default positions with a window).
SPLIT_ATTN = {  # (N, T, S, H, KV, dh, window, cache, position, q dtype, cache dtype)
    "hymba_ring_1024": (4, 1, 1024, 25, 5, 64, 1024, "ring", 1500, "bf16", "fp32"),
    "hymba_global_2048": (4, 1, 2048, 25, 5, 64, None, "global", 1500, "bf16", "fp32"),
    "masked_row": (2, 1, 300, 10, 2, 64, None, "empty", 0, "bf16", "fp32"),
    "ragged_1000": (4, 1, 1000, 25, 5, 64, 1024, "global", 700, "fp32", "fp32"),
    "ragged_150": (2, 1, 150, 10, 2, 64, None, "global", 120, "bf16", "bf16"),
    "dh128_global": (2, 1, 2048, 32, 32, 128, None, "global", 1500, "bf16", "fp32"),
    "dh256_ring": (2, 1, 1024, 16, 8, 256, 1024, "ring", 1500, "bf16", "fp32"),
    "fp32_queries_bf16_cache": (2, 1, 512, 16, 2, 64, None, "global", 400, "fp32", "bf16"),
    "short_prompt_rows60": (2, 12, 12, 25, 5, 64, 5, "arange", 0, "bf16", "bf16"),
    "short_prompt_rows63": (1, 63, 90, 4, 4, 32, None, "arange", 0, "fp32", "fp32"),
}
_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _split_inputs(case, gen):
    n, t, s, h, kv, dh, window, cache, pos, qd, cd = SPLIT_ATTN[case]
    q = torch.randn(n, t, h, dh, device="cuda", generator=gen).to(_DTYPES[qd])
    k, v = (torch.randn(n, s, kv, dh, device="cuda", generator=gen).to(_DTYPES[cd])
            for _ in range(2))
    kw = dict(window=window)
    i32 = dict(device="cuda", dtype=torch.int32)
    kp = torch.arange(s, **i32)
    if cache == "ring":  # slot i holds position i + S once the ring wrapped past it
        kp = torch.where(kp <= pos % s, kp + s, kp)
    elif cache == "global":
        kp[pos + 1:] = -1
    elif cache == "empty":
        kp[:] = -1
    if cache != "arange":
        kw.update(q_positions=torch.tensor([pos], **i32), k_positions=kp)
    return q, k, v, kw


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SPLIT_ATTN))
def test_card_flash_attention_split(cuda, case):
    """Design "split", one counted launch, within TOL / BF16_TOL of the
    plain version and ROW_TOL row by row in bf16, a row with no key the mean
    of all values, and the same bits from call to call."""
    from repro_torch.kernels.flash_attention import design

    q, k, v, kw = _split_inputs(case, cuda)
    assert design(q, k, v, kw["window"], kw.get("q_positions"), kw.get("k_positions")) == "split"
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    want = ref.flash_attention(q, k, v, **kw)
    assert got.dtype == q.dtype and got.shape == want.shape
    assert _rel(got, want) < (CARD_TOL if q.dtype == torch.float32 else BF16_TOL)
    if q.dtype == torch.bfloat16:
        assert _row_rel(got, want) < ROW_TOL
    if SPLIT_ATTN[case][7] == "empty":
        mean = v.float().mean(1, keepdim=True).repeat_interleave(q.shape[2] // k.shape[2], 2)
        assert _rel(got, mean.expand_as(got)) < BF16_TOL
    assert torch.equal(got, ops.flash_attention(q, k, v, **kw))


# The "split" design's copy widths: 16 bytes where the rows and bases allow,
# else 8 (bf16 rows of dh 36), 4 (a float32 cache one element off 16 bytes)
# or 2 (a bf16 cache one element off 4 bytes).  (dtype, dh, offset in elements)
SPLIT_COPIES = {"bf16_dh36_8_bytes": ("bf16", 36, 0), "fp32_off_by_one_4_bytes": ("fp32", 64, 1),
                "bf16_off_by_one_2_bytes": ("bf16", 64, 1)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SPLIT_COPIES))
def test_card_flash_attention_split_copy_widths(cuda, case):
    dtype, dh, off = SPLIT_COPIES[case]
    n, s, h, kv = 2, 300, 10, 2
    cache = []
    for _ in range(2):  # k and v, each a view `off` elements into its buffer
        flat = torch.randn(off + n * s * kv * dh, device="cuda", generator=cuda).to(_DTYPES[dtype])
        cache.append(flat[off:].view(n, s, kv, dh))
    k, v = cache
    q = torch.randn(n, 1, h, dh, device="cuda", generator=cuda).bfloat16()
    kp = torch.arange(s, device="cuda", dtype=torch.int32)
    kp[201:] = -1
    kw = dict(window=None, q_positions=torch.tensor([200], device="cuda", dtype=torch.int32),
              k_positions=kp)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    want = ref.flash_attention(q, k, v, **kw)
    assert _rel(got, want) < BF16_TOL and _row_rel(got, want) < ROW_TOL


# sq_matmul in one launch: M and N off the 128x64 tile (and off 4, the
# 16-byte copies' width), K = 1280 split over a cluster.
SQ_ONE_LAUNCH = {"k128": (128, 300, 100), "k1280": (1280, 300, 100),
                 "k1280_odd_widths": (1280, 131, 67)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(SQ_ONE_LAUNCH))
def test_card_sq_matmul_one_launch_same_bits(cuda, shape):
    """Repeated calls give the same bits: the cluster adds its partial tiles
    in rank order."""
    n, a, b = SQ_ONE_LAUNCH[shape]
    A = torch.randn(n, a, device="cuda", generator=cuda)
    B = torch.randn(n, b, device="cuda", generator=cuda)
    ops.reset_launch_counts()
    first = ops.sq_matmul(A, B)
    assert ops.launch_counts()["sq_matmul"] == 1
    _card_close({"out": first}, {"out": ref.sq_matmul(A, B)})
    _f64_close("sq_matmul", {"out": first}, {"out": ref.sq_matmul(A, B, dtype=torch.float64)})
    if n == 1280:
        assert torch.equal(first, ops.sq_matmul(A, B))


WKV = {  # (N, T, H, dk, dv, per-channel decay, u, state0, chunk)
    "hymba_ssd": (2, 64, 5, 16, 64, False, False, True, 16),
    "hymba_ssd_full_prefill": (4, 2048, 25, 16, 64, False, False, True, 16),
    "rwkv6": (2, 64, 4, 64, 64, True, True, False, 16),
    "ragged_chunk10": (2, 20, 3, 8, 16, True, True, True, 10),
    "dv40_ragged_columns": (2, 96, 3, 16, 40, False, True, True, 16),
    "decode_t1": (3, 1, 5, 16, 64, False, False, True, 1),
    "short_prompt_chunk1": (2, 8, 5, 16, 64, False, False, True, 1),
    "chunk64": (1, 128, 2, 64, 64, True, True, True, 64),
}


def _wkv_inputs(case, dtype, gen):
    n, t, h, dk, dv, per_channel, has_u, has_s0, chunk = WKV[case]
    r, k = (torch.randn(n, t, h, dk, device="cuda", generator=gen).to(dtype) for _ in range(2))
    v = torch.randn(n, t, h, dv, device="cuda", generator=gen).to(dtype)
    lw = -torch.nn.functional.softplus(
        torch.randn(n, t, h, dk if per_channel else 1, device="cuda", generator=gen))
    u = torch.randn(h, dk, device="cuda", generator=gen) if has_u else None
    s0 = torch.randn(n, h, dk, dv, device="cuda", generator=gen) if has_s0 else None
    return r, k, v, lw, u, s0, chunk


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(WKV))
def test_card_wkv(cuda, case, dtype):
    """y is also held row by row in bf16: one row is the dv outputs of one
    (n, t, h)."""
    xs = _wkv_inputs(case, dtype, cuda)
    ops.reset_launch_counts()
    y, s = ops.wkv(*xs)
    assert ops.launch_counts()["wkv"] == 1
    y_want, s_want = ref.wkv(*xs)
    torch.cuda.synchronize()
    assert y.dtype == dtype and s.dtype == torch.float32
    assert _rel(y, y_want) < (CARD_TOL if dtype == torch.float32 else BF16_TOL)
    if dtype == torch.bfloat16:
        assert _row_rel(y, y_want) < ROW_TOL
    assert _rel(s, s_want) < CARD_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["hymba_ssd_full_prefill", "rwkv6", "dv40_ragged_columns",
                                  "decode_t1"])
def test_card_wkv_same_bits(cuda, case):
    """Two calls on the same inputs give the same bits: every sum is taken
    in a fixed order, with no atomics."""
    xs = _wkv_inputs(case, torch.bfloat16, cuda)
    y1, s1 = ops.wkv(*xs)
    y2, s2 = ops.wkv(*xs)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


@pytest.mark.gpu
def test_card_reduced_hymba_serves_like_cpu(cuda):
    """The reduced Hymba: logits card against CPU, a serve_step chain past the
    window-8 ring against the full forward, and one launch of each kernel a
    layer a step."""
    from repro_torch.configs import get_config
    from repro_torch.nn.models import build_model

    cfg = get_config("hymba-1.5b").reduced()
    model = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    params = model.params()
    toks = torch.randint(0, cfg.vocab, (2, 12), device="cuda", generator=cuda)
    full = model.call(params, toks)
    cpu = model.call(tree_map(lambda p: p.cpu(), params), toks.cpu())
    assert _rel(full.cpu(), cpu) < CARD_TOL
    caches = model.init_serve_cache(params, 2, 12, torch.float32)
    for t in range(12):
        ops.reset_launch_counts()
        logits, caches = model.serve_step(params, caches, toks[:, t], t)
        assert ops.launch_counts() == {k: 2 if k in ("flash_attention", "wkv") else 0
                                       for k in ops.KERNELS}
        assert _rel(logits, full[:, t]) < CARD_TOL
