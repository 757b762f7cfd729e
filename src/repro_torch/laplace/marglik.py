"""Laplace evidence ``log p(D | δ, σ)`` and its optimizer.

The marginal likelihood of the Laplace-approximated model is closed form
once a posterior is fitted (MacKay 1992; Immer et al. 2021):

    log p(D | δ, σ) = log p(D | θ*, σ)                    (fit likelihood)
                      − ½ δ ‖θ*‖²                         (prior scatter)
                      − ½ [log det P(δ, σ) − P_dim log δ] (Occam factor)

Every piece is cheap for the diag and Kronecker posteriors, so prior
precision ``δ`` (and observation noise ``σ`` for regression) are tuned by
gradient ascent on the evidence.  Port of ``src/repro/laplace/marglik.py``:
the jitted ``lax.scan`` Adam loop is a Python loop with autograd, with the
same constants over the same parameters (log δ, log σ).  Beyond factor
scale, :func:`log_marglik_matfree` estimates the Occam term by stochastic
Lanczos quadrature over GGN-vector products; its probes come from a
``torch.Generator`` or are passed in (``probe_vectors``), as threefry's
cannot be reproduced.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.core.engine import refuse_mesh
from repro_torch.core.loss_hessian import MSELoss, _f32
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.curv import GGNOperator, slq_logdet

from .posterior import LastLayerLaplace


@dataclasses.dataclass(frozen=True)
class MatfreeEvidence:
    """SLQ-estimated Laplace evidence (no factors materialized)."""

    log_marglik: float
    log_lik: float
    scatter: float
    log_det_ratio: float
    per_probe: torch.Tensor  # individual SLQ quadrature estimates (CPU)


def log_marglik_matfree(model, params, inputs, targets, loss, *, prior_prec: float,
                        sigma_noise: float = 1.0, probes: int = 8, iters: int = 20,
                        rng: Optional[torch.Generator] = None,
                        probe_vectors: Optional[torch.Tensor] = None, cfg=None, mesh=None,
                        shard_axes=("data",)) -> MatfreeEvidence:
    """Laplace evidence with the Occam log-det estimated matrix-free.

    The Occam term

        log det P − P_dim log δ = log det( I + (M/σ²δ) · G_mean )

    is estimated by stochastic Lanczos quadrature over the ratio operator
    (:func:`repro_torch.curv.slq_logdet`; its eigenvalues are ≥ 1), at
    ``probes × iters`` GGN-vector products; ``rng`` (a ``torch.Generator``,
    a CPU one seeded 0 by default) or ``probe_vectors`` (``[probes, P]``
    ±1) give the probes.  The likelihood and scatter terms are exact (one
    forward pass), with :class:`DiagLaplace`'s conventions.  ``cfg`` streams
    each product (``microbatch_size``).
    """
    refuse_mesh("log_marglik_matfree", mesh, shard_axes)
    with torch.no_grad():
        z = model.call(params, inputs)
    loss_map = loss.value(z, targets)
    m = loss.num_units(targets).to(loss_map.dtype).clamp_min(1.0)
    regression = isinstance(loss, MSELoss)
    s, delta = float(sigma_noise), float(prior_prec)
    scale = m / (s * s) if regression else m

    op = GGNOperator(model, params, inputs, targets, loss, cfg=cfg)

    def mv_ratio(v):
        gv = op.mv(v)
        return tree_map(lambda vi, gi: _f32(vi) + (scale / delta) * _f32(gi), v, gv)

    with obs.span("laplace/marglik_matfree", probes=probes, iters=iters):
        slq = slq_logdet(mv_ratio, params, rng=rng, probes=probes, iters=iters,
                         probe_vectors=probe_vectors)
    ld_ratio = slq.logdet
    if regression:
        n_out = m * z.shape[-1]
        log_lik = (-m * loss_map / (s * s) - n_out * math.log(s)
                   - 0.5 * n_out * math.log(2.0 * math.pi))
    else:
        log_lik = -m * loss_map
    sq = sum((_f32(leaf) ** 2).sum() for leaf in tree_leaves(params))
    scatter = delta * sq
    ev = log_lik - 0.5 * (scatter + ld_ratio)
    return MatfreeEvidence(log_marglik=float(ev), log_lik=float(log_lik),
                           scatter=float(scatter), log_det_ratio=float(ld_ratio),
                           per_probe=slq.per_probe.detach().cpu())


def log_marglik(post, prior_prec=None, sigma_noise=None):
    """Laplace evidence of a fitted posterior at (δ, σ), a 0-dimensional
    tensor.  Defaults to the posterior's stored hyperparameters; tensors
    passed for ``prior_prec`` / ``sigma_noise`` keep their autograd graph."""
    return (post.log_lik(sigma_noise)
            - 0.5 * (post.scatter(prior_prec) + post.log_det_ratio(prior_prec, sigma_noise)))


@dataclasses.dataclass(frozen=True)
class MarglikResult:
    prior_prec: float
    sigma_noise: float
    history: torch.Tensor  # evidence per optimizer step (CPU, float32)


def optimize_marglik(post, n_steps: int = 100, lr: float = 0.1,
                     init_prior_prec: Optional[float] = None,
                     init_sigma: Optional[float] = None,
                     tune_sigma: Optional[bool] = None):
    """Tune prior precision (and observation noise) by evidence ascent.

    Returns ``(post', MarglikResult)``: ``post'`` carries the optimized
    hyperparameters (the curvature is reused, never re-swept).
    ``tune_sigma`` defaults to True for regression posteriors.  Adam
    (β = 0.9, 0.999, ε = 1e-8) on (log δ, log σ), in float32 on the
    posterior's device.
    """
    if tune_sigma is None:
        tune_sigma = post.likelihood == "regression"
    inner = post.inner if isinstance(post, LastLayerLaplace) else post
    d0 = float(init_prior_prec if init_prior_prec is not None else inner.prior_prec)
    s0 = float(init_sigma if init_sigma is not None else inner.sigma_noise)
    dev = inner.device

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    theta = torch.log(f32([d0, s0]))
    m = torch.zeros_like(theta)
    v = torch.zeros_like(theta)
    hist = []
    with obs.span("laplace/marglik", n_steps=n_steps, tune_sigma=bool(tune_sigma)):
        for step in range(1, n_steps + 1):
            th = theta.detach().requires_grad_(True)
            sigma = torch.exp(th[1]) if tune_sigma else f32(s0)
            val = -log_marglik(inner, torch.exp(th[0]), sigma)
            (g,) = torch.autograd.grad(val, th)
            if not tune_sigma:
                g = g * f32([1.0, 0.0])
            t = f32(float(step))
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            mh = m / (1.0 - torch.pow(f32(0.9), t))
            vh = v / (1.0 - torch.pow(f32(0.999), t))
            theta = theta - lr * mh / (torch.sqrt(vh) + 1e-8)
            hist.append(-val.detach())
    new_prior = float(torch.exp(theta[0]))
    new_sigma = float(torch.exp(theta[1])) if tune_sigma else s0
    new_inner = dataclasses.replace(inner, prior_prec=new_prior, sigma_noise=new_sigma)
    new_post = (dataclasses.replace(post, inner=new_inner)
                if isinstance(post, LastLayerLaplace) else new_inner)
    history = torch.stack(hist).cpu() if hist else torch.zeros(0)
    return new_post, MarglikResult(prior_prec=new_prior, sigma_noise=new_sigma,
                                   history=history)
