"""Kronecker-factor algebra: π-damped inverses (paper App. C.3, Eq. 28/29).

A Kronecker-factored curvature block is ``G ≈ A ⊗ B`` with ``A`` an
input-side ``[a×a]`` factor (possibly diagonal, stored as a vector — the
embedding case) and ``B`` an output-side ``[b×b]`` factor.

``(A ⊗ B + (λ+η) I)⁻¹`` is approximated per Martens & Grosse (2015):

    (A + π √(λ+η) I)⁻¹ ⊗ (B + (1/π) √(λ+η) I)⁻¹,
    π = sqrt( (tr A / dim A) / (tr B / dim B) ).

Port of ``src/repro/core/kron.py``.  The inverses are ``torch.linalg.inv``
calls, as the JAX package leaves them to ``jnp.linalg.inv``.
"""
from __future__ import annotations

import math

import torch


def pi_factor(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Trace-norm π (Eq. 29). A may be a vector (diagonal factor)."""
    tr_a = A.sum() if A.dim() == 1 else torch.trace(A)
    num = tr_a * B.shape[0]
    den = A.shape[0] * torch.trace(B)
    return torch.sqrt(num.clamp_min(1e-30) / den.clamp_min(1e-30))


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def damped_inverses(A, B, damping):
    """The inverted damped factors (Eq. 28): ``(A_inv, B_inv)``."""
    pi = pi_factor(A, B)
    sd = math.sqrt(damping)
    if A.dim() == 1:
        A_inv = 1.0 / (A + pi * sd)
    else:
        A_inv = torch.linalg.inv(A + pi * sd * _eye(A.shape[0], A))
    B_inv = torch.linalg.inv(B + (sd / pi) * _eye(B.shape[0], B))
    return A_inv, B_inv


def kron_solve(A, B, g, damping):
    """(A⊗B + λI)⁻¹ vec(g) for g of shape [a, b] (weight-matrix layout)."""
    A_inv, B_inv = damped_inverses(A, B, damping)
    g32 = g.float()
    if A.dim() == 1:
        return (A_inv[:, None] * g32) @ B_inv.T
    return A_inv @ g32 @ B_inv.T


def kron_solve_bias(B, g, damping):
    """Bias blocks carry only the B factor (paper footnote 7/8)."""
    B_inv = torch.linalg.inv(B + damping * _eye(B.shape[0], B))
    return B_inv @ g.float()


def kron_mat_vec(A, B, g):
    """(A ⊗ B) vec(g) in weight-matrix layout."""
    g32 = g.float()
    if A.dim() == 1:
        return (A[:, None] * g32) @ B.T
    return A @ g32 @ B.T


def kron_dense(A, B):
    """Materialize A ⊗ B (tests only)."""
    if A.dim() == 1:
        A = torch.diag(A)
    return torch.kron(A, B)
