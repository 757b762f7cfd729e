"""Extension declarations — the quantities BackPACK extracts (paper Table 1/5).

An :class:`Extension` is a pure declaration; the engine inspects the set of
requested extensions to decide which backward sweeps to run:

  * ``first``      — the cotangent sweep (always runs: it also produces the
                     batch gradient).  BatchGrad / BatchL2 / SecondMoment /
                     Variance / BatchDot and the KFAC/KFLR A-factors.
  * ``ggn_exact``  — the exact loss-Hessian factor sweep (DiagGGN, KFLR,
                     GGNTrace); ``ggn_mc`` its Monte-Carlo counterpart
                     (DiagGGNMC, KFAC).
  * ``kfra``       — the batch-averaged Ḡ recursion (paper Eq. 24).
  * ``hess``       — the exact Hessian diagonal (Eq. 25/26).

Port of ``src/repro/core/extensions.py``: the twelve extensions the
monolithic ``run`` serves.  ``reduce`` names the reducer that combines
partial results over a split batch; the reducers themselves come with the
sharded and streaming lanes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Extension:
    """One extractable quantity: its key in ``Results.ext``, the sweep that
    produces it, and the name of the reducer over a split batch."""

    name: str
    sweep: str
    reduce: str = "psum"


# --- first-order extensions (paper §2.2, App. A.1) -------------------------
BatchGrad = Extension("batch_grad", "first", reduce="concat")
"""Per-sample gradients ``[N, *param]`` of the mean loss (paper Eq. 5)."""

BatchL2 = Extension("batch_l2", "first", reduce="concat")
"""Per-sample squared gradient norms ``[N]`` (Eq. 9)."""

BatchDot = Extension("batch_dot", "first", reduce="gram")
"""Pairwise per-sample gradient dots ``[N, N]``."""

SecondMoment = Extension("second_moment", "first", reduce="psum")
"""Batch-scaled second moment ``N·Σ_n g_n²`` per parameter (Eq. 10)."""

Variance = Extension("variance", "first", reduce="moment_merge")
"""Per-parameter gradient variance ``N·Σg² − (Σg)²`` (Eq. 11)."""

# --- second-order extensions (paper §2.3, App. A.2) -------------------------
DiagGGN = Extension("diag_ggn", "ggn_exact", reduce="psum")
"""Exact generalized-Gauss-Newton diagonal per parameter (Eq. 19)."""

DiagGGNMC = Extension("diag_ggn_mc", "ggn_mc", reduce="psum")
"""Monte-Carlo GGN diagonal (the Eq. 20 factorization of Eq. 19)."""

KFLR = Extension("kflr", "ggn_exact", reduce="kron")
"""Kronecker blocks ``A ⊗ B`` with the exact loss-Hessian factor (Eq. 23)."""

KFAC = Extension("kfac", "ggn_mc", reduce="kron")
"""KFAC blocks — the Eq. 23 Kronecker pair with the MC factor in ``B``."""

KFRA = Extension("kfra", "kfra", reduce="pmean")
"""Kronecker factors from the batch-averaged Ḡ recursion (Eq. 24); chain
models only."""

DiagHessian = Extension("diag_hessian", "hess", reduce="psum")
"""Exact Hessian diagonal via signed residual factors (Eq. 25/26); chain
models only."""

GGNTrace = Extension("ggn_trace", "ggn_exact", reduce="concat")
"""Per-sample GGN trace ``[N]``."""

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
)
_BY_NAME = {e.name: e for e in ALL_EXTENSIONS}


def by_name(name: str) -> Extension:
    return _BY_NAME[name]


def sweeps_needed(extensions) -> set:
    return {e.sweep for e in extensions}


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
        tensors); plain einsums otherwise.
    use_fused : bool
        With ``use_kernels``: one fused kernel launch per layer per sweep.
        ``False`` (one kernel per statistic) needs the ``per_sample_moment``
        and ``batch_l2`` kernels, which are not ported yet.
    """

    mc_samples: int = 1
    mc_seed: Optional[int] = None
    class_chunk: Optional[int] = None
    use_kernels: bool = False
    use_fused: bool = True
