"""Lanczos tridiagonalization and its two consumers: SLQ log-det, top-k.

    log det A = tr log A ≈ (1/K) Σ_k  dim · Σ_j τ²_{kj} log λ_{kj}

with Hutchinson (Rademacher) probes ``v_k`` and ``(λ, τ)`` the Ritz
values and first-component weights of an m-step Lanczos tridiagonalization
of ``A`` started at ``v_k`` (Ubaru–Chen–Saad 2017).  ``A`` is touched only
through ``mv``: m products per probe, O(m·P) memory.  The same scan, kept
with its stored basis, gives the top-k Ritz pairs (:func:`lanczos_topk`),
the spectral preconditioner of the NTK regression's Gram-space CG.

Lanczos runs on the raveled vector with full reorthogonalization against
the stored basis.  Port of ``src/repro/curv/logdet.py``.  PyTorch cannot
reproduce JAX's threefry streams, so :func:`slq_logdet` takes a
``torch.Generator`` or the probe vectors themselves, and
:func:`lanczos_topk` a generator or its start vector; generator draws are
made on the generator's device and moved, so one CPU generator gives a CPU
and a CUDA run the same probes.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.loss_hessian import _f32_dtype
from repro_torch.core.tree import tree_leaves, tree_unflatten


class SLQResult(NamedTuple):
    logdet: torch.Tensor      # the MC estimate
    per_probe: torch.Tensor   # [probes] individual quadrature estimates


class TopKResult(NamedTuple):
    eigvals: torch.Tensor     # [k] Ritz values, descending
    eigvecs: torch.Tensor     # [k, dim] matching Ritz vectors (rows)


def lanczos_tridiag(mv_flat: Callable, v0: torch.Tensor, m: int):
    """m-step Lanczos on the flat SPD operator ``mv_flat`` from unit ``v0``.

    Returns ``(alphas [m], betas [m], V [m, dim])``: the tridiagonal
    coefficients and the stored orthonormal basis (row i is the i-th Lanczos
    vector); ``betas[-1]`` is the last step's residual norm.  Full
    reorthogonalization against V every step (unfilled rows are zero).
    """
    V = torch.zeros((m, v0.shape[0]), dtype=v0.dtype, device=v0.device)
    v, v_prev = v0, torch.zeros_like(v0)
    beta_prev = torch.zeros((), dtype=v0.dtype, device=v0.device)
    alphas, betas = [], []
    for i in range(m):
        V[i] = v
        w = mv_flat(v) - beta_prev * v_prev
        alpha = torch.dot(w, v)
        w = w - alpha * v
        w = w - V.T @ (V @ w)
        beta = torch.linalg.norm(w)
        v, v_prev, beta_prev = w / beta.clamp_min(1e-30), v, beta
        alphas.append(alpha)
        betas.append(beta)
    return torch.stack(alphas), torch.stack(betas), V


def _flat_operator(mv: Callable, template):
    """Ravel a tree operator to a flat-vector operator (float32, or float64
    for a float64 template), leaves in ``tree_leaves`` order as JAX's
    ``ravel_pytree``.  Returns ``(mv_flat, dim, dtype, device)``."""
    leaves = tree_leaves(template)
    shapes = [leaf.shape for leaf in leaves]
    sizes = [leaf.numel() for leaf in leaves]
    dtype = _f32_dtype(leaves[0])

    def unravel(x):
        parts = torch.split(x.to(leaves[0].dtype), sizes)
        return tree_unflatten(template, [p.reshape(s) for p, s in zip(parts, shapes)])

    def mv_flat(x):
        return torch.cat([leaf.reshape(-1) for leaf in tree_leaves(mv(unravel(x)))]).to(dtype)

    return mv_flat, sum(sizes), dtype, leaves[0].device


def _tridiag(alphas, betas):
    return torch.diag(alphas) + torch.diag(betas[:-1], 1) + torch.diag(betas[:-1], -1)


def slq_logdet(mv: Callable, template, *, rng: Optional[torch.Generator] = None,
               probes: int = 8, iters: int = 20,
               probe_vectors: Optional[torch.Tensor] = None) -> SLQResult:
    """Estimate ``log det A`` of the SPD operator ``mv``.

    ``template`` is a tree with the operator's domain structure (the params
    tree).  The probes are ``probe_vectors`` (``[probes, dim]`` ±1 entries,
    e.g. JAX's Rademacher draws), or drawn from ``rng`` (a
    ``torch.Generator``; a CPU generator seeded 0 when none is given).
    ``probes`` sets the MC variance, ``iters`` the quadrature accuracy.
    Returns the estimate and the per-probe values (their spread is the
    error bar).
    """
    mv_flat, dim, dtype, device = _flat_operator(mv, template)
    m = min(iters, dim)
    if probe_vectors is None:
        rng = rng if rng is not None else torch.Generator().manual_seed(0)
        probe_vectors = torch.randint(0, 2, (probes, dim), generator=rng,
                                      device=rng.device) * 2 - 1
    if tuple(probe_vectors.shape)[1:] != (dim,):
        raise ValueError(f"slq_logdet: probe vectors must be [probes, {dim}], got "
                         f"{tuple(probe_vectors.shape)}")
    probe_vectors = probe_vectors.to(device=device, dtype=dtype)

    def one_probe(s):
        v0 = s / torch.sqrt(torch.tensor(float(dim), dtype=dtype, device=device))
        alphas, betas, _ = lanczos_tridiag(mv_flat, v0, m)
        lam, U = torch.linalg.eigh(_tridiag(alphas, betas))
        # Breakdown (β → 0: Krylov space exhausted) pads T with decoupled
        # zero modes; their Ritz weight on e₁ is ~0, but clamp λ anyway.
        lam = lam.clamp_min(1e-30)
        return dim * (U[0, :] ** 2 * torch.log(lam)).sum()

    per = torch.stack([one_probe(s) for s in probe_vectors])
    return SLQResult(logdet=per.mean(), per_probe=per)


def lanczos_topk(mv: Callable, template, *, rng: Optional[torch.Generator] = None,
                 k: int, iters: Optional[int] = None,
                 v0: Optional[torch.Tensor] = None) -> TopKResult:
    """Top-k Ritz (eigenvalue, eigenvector) pairs of the SPD operator.

    One m-step Lanczos sweep (``m = iters``, default ``2k + 10``, clamped to
    the dimension) from ``v0`` (normalized here; e.g. JAX's normal draw) or
    a standard normal start drawn from ``rng`` (a CPU generator seeded 0
    when neither is given), the tridiagonal T diagonalized, and its
    eigenvectors lifted through the stored basis: ``y_j = Vᵀ u_j``.
    Eigenvectors are returned raveled (``[k, dim]`` rows).
    """
    mv_flat, dim, dtype, device = _flat_operator(mv, template)
    if k > dim:
        raise ValueError(f"lanczos_topk: k={k} exceeds operator dim={dim}")
    m = min(dim, iters if iters is not None else 2 * k + 10)
    if m < k:
        raise ValueError(f"lanczos_topk: iters={m} < k={k}")
    if v0 is None:
        rng = rng if rng is not None else torch.Generator().manual_seed(0)
        v0 = torch.randn(dim, generator=rng, device=rng.device)
    v0 = v0.to(device=device, dtype=dtype)
    alphas, betas, V = lanczos_tridiag(mv_flat, v0 / torch.linalg.norm(v0), m)
    lam, U = torch.linalg.eigh(_tridiag(alphas, betas))     # ascending
    top = torch.argsort(lam, descending=True)[:k]
    eigvecs = (V.T @ U[:, top]).T                            # [k, dim]
    # Ritz vectors inherit V's orthonormality up to the reorthogonalization
    # tolerance; renormalize so downstream projectors are clean.
    eigvecs = eigvecs / torch.linalg.norm(eigvecs, dim=1, keepdim=True).clamp_min(1e-30)
    return TopKResult(eigvals=lam[top], eigvecs=eigvecs)
