"""Extension declarations — the quantities BackPACK extracts (paper Table 1/5).

An :class:`Extension` is a pure declaration; the engine inspects the set of
requested extensions to decide which backward sweeps to run:

  * ``first``      — the cotangent sweep (always runs: it also produces the
                     batch gradient).  BatchGrad / BatchL2 / SecondMoment /
                     Variance / BatchDot and the KFAC/KFLR A-factors.
  * ``ggn_exact``  — the exact loss-Hessian factor sweep (DiagGGN, KFLR,
                     GGNTrace); ``ggn_mc`` its Monte-Carlo counterpart
                     (DiagGGNMC, KFAC).
  * ``jac``        — the raw-Jacobian sweep with identity cotangents (the
                     empirical NTK family).
  * ``kfra``       — the batch-averaged Ḡ recursion (paper Eq. 24).
  * ``hess``       — the exact Hessian diagonal (Eq. 25/26).

Port of ``src/repro/core/extensions.py``.  ``reduce`` is the
:class:`~repro_torch.core.reducers.Reducer` that combines partial results
over a split batch: the accumulated lane (``SweepPlan.accumulate``) drives it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

from .reducers import (
    CONCAT,
    GRAM,
    GRAM_PAIR,
    KRON,
    MOMENT_MERGE,
    PMEAN,
    PSUM,
    Reducer,
    resolve_reducer,
)


@dataclasses.dataclass(frozen=True)
class Extension:
    """One extractable quantity: its key in ``Results.ext``, the sweep that
    produces it, and the :class:`Reducer` of its partial results over a
    split batch.  A registered string name (``reduce='gram'``) still
    resolves, with a ``DeprecationWarning`` naming the instance."""

    name: str
    sweep: str
    reduce: Union[Reducer, str] = PSUM

    def __post_init__(self):
        if not isinstance(self.reduce, Reducer):
            object.__setattr__(self, "reduce", resolve_reducer(self.reduce))


# --- first-order extensions (paper §2.2, App. A.1) -------------------------
BatchGrad = Extension("batch_grad", "first", reduce=CONCAT)
"""Per-sample gradients ``[N, *param]`` of the mean loss (paper Eq. 5)."""

BatchL2 = Extension("batch_l2", "first", reduce=CONCAT)
"""Per-sample squared gradient norms ``[N]`` (Eq. 9)."""

BatchDot = Extension("batch_dot", "first", reduce=GRAM)
"""Pairwise per-sample gradient dots ``[N, N]``."""

SecondMoment = Extension("second_moment", "first", reduce=PSUM)
"""Batch-scaled second moment ``N·Σ_n g_n²`` per parameter (Eq. 10)."""

Variance = Extension("variance", "first", reduce=MOMENT_MERGE)
"""Per-parameter gradient variance ``N·Σg² − (Σg)²`` (Eq. 11)."""

# --- second-order extensions (paper §2.3, App. A.2) -------------------------
DiagGGN = Extension("diag_ggn", "ggn_exact", reduce=PSUM)
"""Exact generalized-Gauss-Newton diagonal per parameter (Eq. 19)."""

DiagGGNMC = Extension("diag_ggn_mc", "ggn_mc", reduce=PSUM)
"""Monte-Carlo GGN diagonal (the Eq. 20 factorization of Eq. 19)."""

KFLR = Extension("kflr", "ggn_exact", reduce=KRON)
"""Kronecker blocks ``A ⊗ B`` with the exact loss-Hessian factor (Eq. 23)."""

KFAC = Extension("kfac", "ggn_mc", reduce=KRON)
"""KFAC blocks — the Eq. 23 Kronecker pair with the MC factor in ``B``."""

KFRA = Extension("kfra", "kfra", reduce=PMEAN)
"""Kronecker factors from the batch-averaged Ḡ recursion (Eq. 24); chain
models only."""

DiagHessian = Extension("diag_hessian", "hess", reduce=PSUM)
"""Exact Hessian diagonal via signed residual factors (Eq. 25/26); chain
models only."""

GGNTrace = Extension("ggn_trace", "ggn_exact", reduce=CONCAT)
"""Per-sample GGN trace ``[N]``."""

# --- empirical NTK family (Gram blocks of the Jacobian) ---------------------
NTK = Extension("ntk", "jac", reduce=GRAM)
"""Empirical NTK blocks ``[N, N]`` per parameter, ``Θ[n, m] = Σ_c
⟨J_c(x_n), J_c(x_m)⟩`` from raw output Jacobians (no loss weighting);
flat ``[N, C]`` outputs only.  :func:`repro_torch.core.engine.ntk_total`
sums the leaves into the kernel."""

NTKClasswise = Extension("ntk_classwise", "jac", reduce=GRAM)
"""Class-diagonal empirical NTK ``[N, N, C]`` per parameter,
``Θ[n, m, c] = ⟨J_c(x_n), J_c(x_m)⟩``."""

GGNGram = Extension("ggn_gram", "ggn_exact", reduce=GRAM_PAIR)
"""Loss-scaled logit-space GGN Gram blocks ``[N, N, C̃, C̃]`` per parameter,
``K[n, m, c, c'] = ⟨Jᵀ√H-col c of x_n, Jᵀ√H-col c' of x_m⟩``;
:func:`repro_torch.core.engine.gram_total` sums them into the ``[N·C̃]``
kernel that kernel-space natural gradients solve against."""

ALL_EXTENSIONS = (
    BatchGrad,
    BatchL2,
    BatchDot,
    SecondMoment,
    Variance,
    DiagGGN,
    DiagGGNMC,
    KFLR,
    KFAC,
    KFRA,
    DiagHessian,
    GGNTrace,
    NTK,
    NTKClasswise,
    GGNGram,
)
_BY_NAME = {e.name: e for e in ALL_EXTENSIONS}


def by_name(name: str) -> Extension:
    return _BY_NAME[name]


def sweeps_needed(extensions) -> set:
    return {e.sweep for e in extensions}


def reduce_spec(extensions) -> dict:
    """``{extension name: Reducer}`` for a set of extensions: the table the
    accumulated lane drives."""
    return {e.name: e.reduce for e in extensions}


@dataclasses.dataclass(frozen=True)
class FusedMask:
    """Static extension mask for the fused first-order kernel: ``l2`` ↔
    BatchL2, ``moment`` ↔ SecondMoment/Variance, ``dot`` ↔ BatchDot.  An unset
    flag means that output is never allocated or computed."""

    l2: bool = False
    moment: bool = False
    dot: bool = False

    def any(self) -> bool:
        return self.l2 or self.moment or self.dot

    def wants(self):
        """Kwargs for ``kernels.ops.fused_first_order``."""
        return dict(want_l2=self.l2, want_moment=self.moment,
                    want_dot=self.dot)


def first_order_mask(exts_or_names) -> FusedMask:
    """Fused-kernel mask for a set of extensions (or extension names)."""
    names = {e if isinstance(e, str) else e.name for e in exts_or_names}
    return FusedMask(
        l2="batch_l2" in names,
        moment=bool(names & {"second_moment", "variance"}),
        dot="batch_dot" in names,
    )


@dataclasses.dataclass(frozen=True)
class FusedSecondMask:
    """Static extension mask for the fused curvature kernel: ``diag`` ↔
    DiagGGN/DiagGGNMC, ``kron`` ↔ the KFLR/KFAC B-factor, ``trace`` ↔
    GGNTrace."""

    diag: bool = False
    kron: bool = False
    trace: bool = False

    def any(self) -> bool:
        return self.diag or self.kron or self.trace

    def wants(self):
        """Kwargs for ``kernels.ops.fused_second_order``."""
        return dict(want_diag=self.diag, want_kron=self.kron,
                    want_trace=self.trace)


def second_order_mask(exts_or_names) -> FusedSecondMask:
    """Fused-curvature-kernel mask for a set of extensions (or names); the
    exact sweep's {diag_ggn, kflr, ggn_trace} and the MC sweep's
    {diag_ggn_mc, kfac} land on the same outputs."""
    names = {e if isinstance(e, str) else e.name for e in exts_or_names}
    return FusedSecondMask(
        diag=bool(names & {"diag_ggn", "diag_ggn_mc"}),
        kron=bool(names & {"kflr", "kfac"}),
        trace="ggn_trace" in names,
    )


@dataclasses.dataclass(frozen=True)
class ExtensionConfig:
    """Knobs of the monolithic sweep.

    Parameters
    ----------
    mc_samples : int
        Number of Monte-Carlo columns C̃ of the MC loss-Hessian factor
        (paper Eq. 20).
    mc_seed : int, optional
        Seed of the MC draws when ``run`` gets no ``rng``.
    class_chunk : int, optional
        Process the exact factor's leading U·C axis in chunks of this size.
    use_kernels : bool
        Route the reductions through :mod:`repro_torch.kernels.ops` (the
        Hopper kernels on CUDA tensors, their plain versions on CPU
        tensors); plain einsums otherwise.  On by default, unlike the JAX
        package's ``False``: on the card the kernels are the port's route.
    use_fused : bool
        With ``use_kernels``: one fused kernel launch per layer per sweep.
        ``False`` is the paper's per-extension route, one kernel per
        statistic (``per_sample_moment``, ``batch_l2``).
    microbatch_size : int, optional
        Stream the sweep over slices of at most this many samples (the
        accumulated lane, ``SweepPlan.accumulate``): the consumers
        (``make_extended_train_step``, the Laplace fits) compose their lane
        through ``engine.plan_for_batch``, which folds each extension's
        ``reduce`` over ``ceil(N / microbatch_size)`` slices.

    The remaining fields are set by the accumulated lane for the slice runs
    it drives; never set them by hand.  ``total_units`` is the mask-aware
    unit count M of the WHOLE batch (the loss adapter rescales a slice's
    factors to the global 1/M), ``total_batch`` the whole batch's sample
    count N (the batch-size scale of SecondMoment/Variance),
    ``sample_offset`` the global index of the slice's first sample (its MC
    draws are the whole batch's at those indices), ``accum_stats`` makes the
    engine emit mergeable raw accumulators (Chan (count, mean, M2) triples
    for Variance, KFRA's ``{gbar, partials}``) instead of finalized
    statistics, and ``cross_split`` marks a pair pass: the batch is two
    slices concatenated, and the pairwise statistics (BatchDot, the NTKs,
    GGNGram) emit only the cross block ``rows[:cross_split] ×
    rows[cross_split:]``, through ``kernels.ops.cross_dot`` when kernels
    are on.
    """

    mc_samples: int = 1
    mc_seed: Optional[int] = None
    class_chunk: Optional[int] = None
    use_kernels: bool = True
    use_fused: bool = True
    microbatch_size: Optional[int] = None
    # --- set by the accumulated lane ----------------------------------------
    total_units: Optional[Any] = None
    total_batch: Optional[int] = None
    sample_offset: int = 0
    accum_stats: bool = False
    cross_split: Optional[int] = None
