"""Why the 3xTF32 kernels (cross_dot, fused_second_order, fused_first_order,
per_sample_moment) split their operands, and what ``chip_smoke.py``'s
float64 limits guard: TF32 rounding emulated on the CPU, with no card and no
JAX.

``cvt.rna.tf32.f32`` keeps 10 of float32's 23 mantissa bits, rounding to
nearest with ties away from zero.  A kernel in 3xTF32 splits each float32
x into hi = tf32(x) and lo = tf32(x − hi) and adds lo·hi + hi·lo + hi·hi;
1xTF32 adds hi·hi alone.  Products and sums are taken here in float64, so
these tests see the splits' error and nothing of the card's float32
accumulation (which ``F64_TOL`` and ``ENTRY_TOL`` leave room for).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import ENTRY_TOL, F64_TOL, f64_readings  # noqa: E402


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on float32 values (finite, away from the overflow)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, eq: str, terms: int) -> torch.Tensor:
    """einsum ``eq`` of float32 a and b in float64 from their TF32 parts:
    3 terms (lo·hi + hi·lo + hi·hi) or 1 (hi·hi)."""
    ah, al = (x.double() for x in split(a))
    bh, bl = (x.double() for x in split(b))
    out = torch.einsum(eq, ah, bh)
    if terms == 3:
        out = out + torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
    return out


def readings(got: torch.Tensor, want: torch.Tensor, entries: torch.Tensor):
    """chip_smoke's two readings: whole-tensor max |got − want| / max |want|
    and the median of |got − want| / |want| over the chosen entries."""
    err = (got - want).abs()
    return (err.max() / want.abs().max()).item(), (err / want.abs())[entries].median().item()


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 1e3, 1e30])
def test_split_within_2_pow_minus_22(scale):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(100_000).astype(np.float32))
    x = x * np.float32(scale)
    hi, lo = split(x)
    rest = (x.double() - hi.double() - lo.double()).abs()
    assert (rest <= 2.0 ** -22 * x.double().abs()).all()
    # hi alone (1xTF32) is off by up to 2^-11 of x, far above the split's bound
    assert ((x.double() - hi.double()).abs() / x.double().abs()).max() > 2.0 ** -13


def _conv3_rows(rows=16, seed=0):
    """Per-sample gradients G_n = A_nᵀS_n at 3C3D's conv3 (R 64, a 864, b
    128: a·b = 110,592, cross_dot's deepest K), A a ReLU'd normal, S a
    normal · 0.1, as the float32 rows cross_dot's Gram stage reads."""
    rng = np.random.default_rng(seed)
    A = np.maximum(rng.standard_normal((rows, 64, 864)), 0)
    S = 0.1 * rng.standard_normal((rows, 64, 128))
    return torch.from_numpy(np.einsum("nra,nrb->nab", A, S).reshape(rows, -1).astype(np.float32))


@pytest.mark.parametrize("terms", [3, 1], ids=["3xtf32", "1xtf32"])
def test_conv3_gram_against_float64(terms):
    """At cross_dot's conv3 depth the 3xTF32 Gram meets both limits and
    1xTF32 fails the entry limit: it tells a right kernel from one that
    skips the split, which TOL (1e-4 whole-tensor against float32) cannot.
    1xTF32's whole-tensor reading (≈ 4e-6 here) is not asserted: the large
    diagonal entries set the scale it divides by."""
    G = _conv3_rows()
    want = G.double() @ G.double().T
    got = product(G, G, "nk,mk->nm", terms)
    rel, median = readings(got, want, ~torch.eye(len(G), dtype=torch.bool))
    if terms == 3:
        assert rel <= F64_TOL / 3 and median <= ENTRY_TOL / 3, (rel, median)
    else:
        assert median > ENTRY_TOL, (rel, median)
        assert rel < 1e-4  # why TOL alone cannot see it


@pytest.mark.parametrize("terms", [3, 1], ids=["3xtf32", "1xtf32"])
def test_second_order_diag_against_float64(terms):
    """fused_second_order's diag Σ_cn (A_nᵀS_cn)² at conv2's widths (R 256,
    a 576, b 96), ten classes, eight samples: the same split of roles."""
    rng = np.random.default_rng(1)
    A = torch.from_numpy(rng.standard_normal((8, 256, 576)).astype(np.float32))
    S = torch.from_numpy(rng.standard_normal((10, 8, 256, 96)).astype(np.float32))
    want = torch.einsum("nra,cnrb->cnab", A.double(), S.double()).square().sum((0, 1))
    got = product(A, S, "nra,cnrb->cnab", terms).square().sum((0, 1))
    rel, median = readings(got, want, torch.ones_like(want, dtype=torch.bool))
    if terms == 3:
        assert rel <= F64_TOL / 3 and median <= ENTRY_TOL / 3, (rel, median)
    else:
        assert rel > F64_TOL, (rel, median)


def _per_sample_inputs(rows, repeat, seed):
    """A [rows·repeat, 64, 96] (a ReLU'd normal, its rows repeated as the
    exact diagonal's call site broadcasts the layer input over ten classes)
    and B [rows·repeat, 64, 32] (a normal · 0.1): conv3's R 64 at widths
    reduced for time."""
    rng = np.random.default_rng(seed)
    A = np.maximum(rng.standard_normal((rows, 64, 96)), 0).astype(np.float32)
    B = (0.1 * rng.standard_normal((rows * repeat, 64, 32))).astype(np.float32)
    return torch.from_numpy(np.tile(A, (repeat, 1, 1))), torch.from_numpy(B)


def _assert_tells(terms, reading):
    """3xTF32 within a third of both limits (no float32 sums here); 1xTF32
    outside both: the card's checks fail it at every row."""
    if terms == 3:
        assert reading["rel64"] <= F64_TOL / 3, reading
        assert reading["entry_median"] <= ENTRY_TOL / 3, reading
    else:
        assert reading["rel64"] > F64_TOL, reading
        assert reading["entry_median"] > ENTRY_TOL, reading


@pytest.mark.parametrize("terms", [3, 1], ids=["3xtf32", "1xtf32"])
def test_per_sample_moment_against_float64(terms):
    """per_sample_moment's Σ_n (A_nᵀB_n)∘² at the exact diagonal's 1280 rows
    (128 samples × 10 classes), as chip_smoke reads it."""
    A, B = _per_sample_inputs(128, 10, seed=2)
    want = torch.einsum("nra,nrb->nab", A.double(), B.double()).square().sum(0)
    got = product(A, B, "nra,nrb->nab", terms).square().sum(0)
    _assert_tells(terms, f64_readings(torch, "per_sample_moment", {"out": got},
                                      {"out": want}))


@pytest.mark.parametrize("terms", [3, 1], ids=["3xtf32", "1xtf32"])
def test_first_order_dot_and_moment_against_float64(terms):
    """fused_first_order at 128 rows: G_n in 3xTF32 (or 1xTF32), the moment
    Σ_n G∘G and l2 from it, and dot = G Gᵀ from G stored in float32 and split
    again for the Gram, as the card computes it; dot's entries read off the
    diagonal."""
    A, B = _per_sample_inputs(128, 1, seed=3)
    G64 = torch.einsum("nra,nrb->nab", A.double(), B.double()).flatten(1)
    want = dict(l2=G64.square().sum(1), moment=G64.square().sum(0), dot=G64 @ G64.T)
    G = product(A, B, "nra,nrb->nab", terms).flatten(1)
    got = dict(l2=G.square().sum(1), moment=G.square().sum(0),
               dot=product(G.float(), G.float(), "nk,mk->nm", terms))
    _assert_tells(terms, f64_readings(torch, "fused_first_order", got, want))
