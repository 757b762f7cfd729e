"""Laplace posteriors fitted from one ``core.engine`` run.

A Laplace approximation around the MAP estimate ``θ*`` is the Gaussian
``N(θ*, P⁻¹)`` with posterior precision

    P = H_lik + δ I,       H_lik ≈ M · G(θ*) / σ²

where ``G`` is the engine's GGN approximation of the **mean**-loss
curvature (the 1/M of the objective is folded into the propagated factors),
``M`` the number of sample units, ``δ`` the prior precision and ``σ`` the
observation noise (regression only).

* :class:`DiagLaplace` — elementwise precisions from DiagGGN / DiagGGNMC;
* :class:`KronLaplace` — per-layer Kronecker blocks ``A ⊗ B`` from KFLR /
  KFAC, damped with the Martens–Grosse π split:
  ``P_block = (A + π√δ I) ⊗ (M·B/σ² + √δ/π I)``, with closed-form
  log-determinants and samples;
* :class:`LastLayerLaplace` — either structure on the final Dense layer of a
  Sequential model, the feature extractor a point estimate.

Port of ``src/repro/laplace/posterior.py``.  The fitting sweep is the
port's single-device lane (``plan_for_batch``): a ``mesh`` or a
``microbatch_size`` that cuts the batch into several slices raises
``NotImplementedError``, and ``ckpt_dir`` raises
:class:`LaplaceStructureError` as it does on a non-streamed plan in JAX.
Samples take a ``torch.Generator`` or the standard-normal draws themselves
(a tree mirroring the parameters, each leaf with the leading sample axis),
as the MC sweep takes its draws.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, ClassVar, Optional

import torch

from repro_torch.core import kron as K
from repro_torch.core.engine import plan_for_batch, plan_sweeps
from repro_torch.core.extensions import KFAC, KFLR, DiagGGN, DiagGGNMC, ExtensionConfig
from repro_torch.core.loss_hessian import CrossEntropyLoss, MSELoss, _f32, _f32_dtype
from repro_torch.core.module import Dense, Sequential
from repro_torch.core.tree import tree_leaves, tree_map, tree_structure, tree_unflatten


class LaplaceStructureError(ValueError):
    """A Laplace fit/predictive was asked for a structure the sweep plan or
    model cannot serve; the message says what to change."""


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def _n_units(loss, y) -> float:
    """Number of sample units M (the 1/M folded into engine factors)."""
    if isinstance(loss, CrossEntropyLoss):
        return float(max(int((y >= 0).sum()), 1))
    if isinstance(loss, MSELoss):
        return float(max(y.numel() // y.shape[-1], 1))
    raise LaplaceStructureError(
        f"laplace: unsupported loss {type(loss).__name__} "
        "(CrossEntropyLoss or MSELoss)")


def _likelihood_of(loss) -> str:
    return "regression" if isinstance(loss, MSELoss) else "classification"


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A scalar on ``like``'s device, in float32 or in float64 where ``like``
    is float64 (a hyperparameter: a number, or a tensor that autograd
    follows)."""
    return torch.as_tensor(v, dtype=_f32_dtype(like), device=like.device)


@dataclasses.dataclass(frozen=True)
class FitOptions:
    """Every Laplace-fit knob, in one place::

        post = fit_posterior(model, params, x, y, loss, structure="kron",
                             options=FitOptions(mc=True, prior_prec=0.5))

    Passing the fields as keywords still works but emits a
    ``DeprecationWarning``.

    Fields
    ------
    mc : bool
        Monte-Carlo curvature (DiagGGNMC / KFAC) instead of the exact
        factorization (Eq. 20).
    prior_prec : float
        Initial prior precision ``δ`` (tunable with ``optimize_marglik``).
    cfg, rng, extensions
        Engine sweep configuration: ``ExtensionConfig``, the MC draws (a
        ``torch.Generator`` or the draws), and an explicit extension tuple
        overriding the structure default.
    mesh, shard_axes
        Batch-shard the fitting sweep (not ported yet: raises).
    microbatch_size
        Stream it (not ported yet: raises when it cuts the batch).
    ckpt_dir, resume, checkpoint_every, injector
        Preemption-safe streaming fit; needs the streamed lane, so it
        raises :class:`LaplaceStructureError` here.
    """

    mc: bool = False
    prior_prec: float = 1.0
    cfg: Optional[ExtensionConfig] = None
    rng: Any = None
    extensions: Any = None
    mesh: Any = None
    shard_axes: Any = ("data",)
    microbatch_size: Optional[int] = None
    ckpt_dir: Optional[str] = None
    resume: bool = False
    checkpoint_every: int = 1
    injector: Any = None

    def replace(self, **kw) -> "FitOptions":
        return dataclasses.replace(self, **kw)


_FIT_OPTION_NAMES = tuple(f.name for f in dataclasses.fields(FitOptions))


def _merge_fit_options(options, legacy, caller):
    """Resolve ``options=FitOptions(...)`` against legacy keywords: folded
    over ``options`` with a ``DeprecationWarning``; unknown keywords raise
    ``TypeError`` as a real signature would."""
    if not legacy:
        return options if options is not None else FitOptions()
    unknown = sorted(k for k in legacy if k not in _FIT_OPTION_NAMES)
    if unknown:
        raise TypeError(
            f"{caller}: unexpected keyword argument(s) {unknown} "
            f"(FitOptions fields: {list(_FIT_OPTION_NAMES)})")
    names = ", ".join(f"{k}=..." for k in sorted(legacy))
    warnings.warn(
        f"{caller}: passing {sorted(legacy)} as keywords is deprecated — "
        f"pass options=FitOptions({names}) instead",
        DeprecationWarning, stacklevel=3)
    return dataclasses.replace(options if options is not None else FitOptions(), **legacy)


def _run_sweep(model, params, x, y, loss, extensions, cfg, rng, mesh, shard_axes,
               microbatch_size=None, ckpt_dir=None):
    """One engine sweep on the lane ``plan_for_batch`` gives this batch."""
    n = tree_leaves(x)[0].shape[0]
    plan = plan_for_batch(extensions, cfg, n, mesh=mesh, shard_axes=shard_axes,
                          microbatch_size=microbatch_size)
    if ckpt_dir is not None:
        raise LaplaceStructureError(
            "laplace: ckpt_dir needs the streaming accumulated sweep "
            "lane — pass microbatch_size (or cfg.microbatch_size) small "
            "enough to split the fit batch into more than one slice, so "
            "the sweep has checkpointable work units "
            f"(plan: {plan.describe()})")
    return plan.run(model, params, x, y, loss, cfg=cfg, rng=rng)


def _is_kron_block(node) -> bool:
    return isinstance(node, dict) and "B" in node and set(node) <= {"A", "B", "A_diag"}


def _map_kron(fn, mean, kron, path="params", extra=None):
    """Map ``fn(mean_leaf, block[, extra_leaf])`` over parameter leaves
    zipped with their Kronecker blocks (and a tree ``extra`` of the mean's
    structure), keeping the mean's structure.  A leaf without a block is a
    structure error."""
    if isinstance(mean, dict):
        k_d = kron if isinstance(kron, dict) else {}
        return {k: _map_kron(fn, v, k_d.get(k), f"{path}.{k}",
                             None if extra is None else extra[k])
                for k, v in mean.items()}
    if isinstance(mean, (tuple, list)):
        k_t = (kron if isinstance(kron, (tuple, list)) and len(kron) == len(mean)
               else (None,) * len(mean))
        x_t = (None,) * len(mean) if extra is None else extra
        return tuple(_map_kron(fn, m, c, f"{path}[{i}]", xi)
                     for i, (m, c, xi) in enumerate(zip(mean, k_t, x_t)))
    if not isinstance(mean, torch.Tensor):
        return mean
    if not _is_kron_block(kron):
        raise LaplaceStructureError(
            f"KronLaplace: no Kronecker factors for {path} — the engine "
            "emits KFLR/KFAC blocks for Dense/Conv2d/Embedding layers only; "
            "for other models fit with last_layer=True or DiagLaplace")
    return fn(mean, kron) if extra is None else fn(mean, kron, extra)


def _require_structure(structure: str, extensions, cfg) -> None:
    plan = plan_sweeps(extensions, cfg)
    if structure not in plan.posterior_structures():
        raise LaplaceStructureError(
            f"laplace: sweep plan cannot serve a '{structure}' posterior "
            f"(plan: {plan.describe()}); add DiagGGN/DiagGGNMC for 'diag' "
            "or KFLR/KFAC for 'kron'")


def _inv_sqrt_psd(M):
    """Symmetric inverse square root of an SPD matrix via eigh."""
    w, U = torch.linalg.eigh(M)
    return (U * torch.rsqrt(w.clamp_min(1e-30))) @ U.T


def _cov_half(M):
    """L with L Lᵀ = M⁻¹ for SPD M (eigh-based)."""
    w, U = torch.linalg.eigh(M)
    return U * torch.rsqrt(w.clamp_min(1e-30))


def _logdet(M):
    if M.dim() == 1:
        return torch.log(M.clamp_min(1e-30)).sum()
    return torch.linalg.slogdet(M)[1]


def _normal_draws(rng, mean, n_samples):
    """Standard-normal draws [K, *leaf.shape] for every leaf of ``mean``, in
    :func:`tree_leaves` order: from a ``torch.Generator`` (made on its
    device), or given as a tree of ``mean``'s structure."""
    leaves = tree_leaves(mean)
    if isinstance(rng, torch.Generator):
        return [torch.randn((n_samples,) + tuple(m.shape), generator=rng,
                            device=rng.device).to(m.device) for m in leaves]
    draws = tree_leaves(rng)
    if len(draws) != len(leaves):
        raise ValueError(f"sample: {len(draws)} draws for {len(leaves)} parameter leaves")
    out = []
    for m, d in zip(leaves, draws):
        d = torch.as_tensor(d, dtype=_f32_dtype(m)).to(m.device)
        if tuple(d.shape) != (n_samples,) + tuple(m.shape):
            raise ValueError(f"sample: draws of shape {tuple(d.shape)} for a leaf of "
                             f"shape {tuple(m.shape)} and {n_samples} samples")
        out.append(d)
    return out


# ---------------------------------------------------------------------------
# shared evidence plumbing
# ---------------------------------------------------------------------------


class _EvidenceMixin:
    """Evidence pieces common to the Gaussian posteriors here (dataclasses
    with ``mean`` / ``n_data`` / ``loss_map`` / ``likelihood`` /
    ``n_outputs`` / ``prior_prec`` / ``sigma_noise``)."""

    @property
    def device(self) -> torch.device:
        return tree_leaves(self.mean)[0].device

    @property
    def _like(self) -> torch.Tensor:
        """A leaf of the mean: its device, and float64 if the fit was."""
        return tree_leaves(self.mean)[0]

    def _curv_scale(self, sigma_noise=None):
        """Mean-loss curvature → sum-loss likelihood Hessian: M (/σ²)."""
        s = _scalar(self.sigma_noise if sigma_noise is None else sigma_noise, self._like)
        m = _scalar(self.n_data, self._like)
        return m / (s * s) if self.likelihood == "regression" else m

    def n_params(self) -> int:
        return int(sum(leaf.numel() for leaf in tree_leaves(self.mean)))

    def scatter(self, prior_prec=None):
        d = self.prior_prec if prior_prec is None else prior_prec
        sq = sum((_f32(leaf) ** 2).sum() for leaf in tree_leaves(self.mean))
        return _scalar(d, self._like) * sq

    def log_lik(self, sigma_noise=None):
        s = _scalar(self.sigma_noise if sigma_noise is None else sigma_noise, self._like)
        m = _scalar(self.n_data, self._like)
        if self.likelihood == "regression":
            n_out = _scalar(self.n_data * self.n_outputs, self._like)
            return (-m * self.loss_map / (s * s) - n_out * torch.log(s)
                    - 0.5 * n_out * math.log(2.0 * math.pi))
        return -m * self.loss_map


# ---------------------------------------------------------------------------
# diagonal posterior
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DiagLaplace(_EvidenceMixin):
    """Diagonal-precision Laplace posterior.

    ``curv`` is the engine's mean-loss GGN diagonal tree (the structure of
    ``mean``); the likelihood scale ``n_data/σ²`` and the prior ``δ`` are
    applied when used, so both can be re-tuned without a new sweep.
    """

    mean: Any
    curv: Any
    n_data: float
    loss_map: float
    likelihood: str = "classification"
    n_outputs: int = 1
    prior_prec: float = 1.0
    sigma_noise: float = 1.0

    structure: ClassVar[str] = "diag"

    @classmethod
    def fit(cls, model, params, x, y, loss, *, options: Optional[FitOptions] = None,
            **legacy):
        o = _merge_fit_options(options, legacy, "DiagLaplace.fit")
        cfg, extensions, rng = _fit_args(o.cfg, o.extensions, o.rng, o.mc,
                                         default=(DiagGGNMC,) if o.mc else (DiagGGN,))
        _require_structure("diag", extensions, cfg)
        res = _run_sweep(model, params, x, y, loss, extensions, cfg, rng, o.mesh,
                         o.shard_axes, o.microbatch_size, o.ckpt_dir)
        name = "diag_ggn_mc" if "diag_ggn_mc" in res.ext else "diag_ggn"
        curv = res.ext[name]
        if tree_structure(params) != tree_structure(curv):
            raise LaplaceStructureError(
                "DiagLaplace: curvature tree does not cover every parameter; "
                "the engine emits GGN diagonals for Dense/Conv2d layers — for "
                "other models fit with last_layer=True")
        return cls(mean=params, curv=tree_map(_f32, curv),
                   n_data=_n_units(loss, y), loss_map=float(res.loss),
                   likelihood=_likelihood_of(loss), n_outputs=int(res.logits.shape[-1]),
                   prior_prec=float(o.prior_prec))

    def precision(self, prior_prec=None, sigma_noise=None):
        """Posterior precision tree: curv·(M/σ²) + δ."""
        d = self.prior_prec if prior_prec is None else prior_prec
        scale = self._curv_scale(sigma_noise)
        return tree_map(lambda c: c * scale + d, self.curv)

    def log_det_ratio(self, prior_prec=None, sigma_noise=None):
        """log det P − P_dim · log δ  (the evidence's Occam term), summed as
        Σ log1p(curv·(M/σ²)/δ): the same quantity without the cancellation
        of two sums of P_dim terms in float32."""
        d = _scalar(self.prior_prec if prior_prec is None else prior_prec, self._like)
        scale = self._curv_scale(sigma_noise)
        return sum(torch.log1p(leaf * scale / d).sum() for leaf in tree_leaves(self.curv))

    def sample(self, rng, n_samples: int = 1):
        """Posterior samples as a params tree with leading axis K; ``rng`` is
        a ``torch.Generator`` or the standard-normal draws (a params-shaped
        tree, each leaf ``[K, *leaf.shape]``)."""
        eps = _normal_draws(rng, self.mean, n_samples)
        out = [_f32(m)[None] + e * torch.rsqrt(p)[None]
               for m, p, e in zip(tree_leaves(self.mean), tree_leaves(self.precision()), eps)]
        return tree_unflatten(self.mean, out)

    def cov_diag(self, curv_leaf):
        """Elementwise posterior variance for one parameter leaf."""
        scale = self._curv_scale(self.sigma_noise)
        return 1.0 / (curv_leaf * scale + self.prior_prec)

    def layer_blocks(self):
        return self.curv


# ---------------------------------------------------------------------------
# Kronecker posterior
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KronLaplace(_EvidenceMixin):
    """Kronecker-factored Laplace posterior (π-damped, App. C.3).

    ``kron`` is the engine's KFLR/KFAC stats tree: per layer
    ``{'w': {'A': [a,a] | 'A_diag': [a], 'B': [b,b]}, 'b': {'B': [b,b]}}``;
    ``B`` is scaled by ``n_data/σ²`` when used.
    """

    mean: Any
    kron: Any
    n_data: float
    loss_map: float
    likelihood: str = "classification"
    n_outputs: int = 1
    prior_prec: float = 1.0
    sigma_noise: float = 1.0

    structure: ClassVar[str] = "kron"

    @classmethod
    def fit(cls, model, params, x, y, loss, *, options: Optional[FitOptions] = None,
            **legacy):
        o = _merge_fit_options(options, legacy, "KronLaplace.fit")
        cfg, extensions, rng = _fit_args(o.cfg, o.extensions, o.rng, o.mc,
                                         default=(KFAC,) if o.mc else (KFLR,))
        _require_structure("kron", extensions, cfg)
        res = _run_sweep(model, params, x, y, loss, extensions, cfg, rng, o.mesh,
                         o.shard_axes, o.microbatch_size, o.ckpt_dir)
        kron_tree = res.ext["kfac" if "kfac" in res.ext else "kflr"]
        _map_kron(lambda m, b: None, params, kron_tree)  # every leaf owns a block
        return cls(mean=params, kron=kron_tree, n_data=_n_units(loss, y),
                   loss_map=float(res.loss), likelihood=_likelihood_of(loss),
                   n_outputs=int(res.logits.shape[-1]), prior_prec=float(o.prior_prec))

    def damped_factors(self, block, prior_prec=None, sigma_noise=None):
        """π-damped posterior-precision factors ``(A', B')`` of one block,
        ``P ≈ A' ⊗ B'``; bias blocks (no A factor) give
        ``(None, M·B/σ² + δ I)``."""
        d = self.prior_prec if prior_prec is None else prior_prec
        s = self.sigma_noise if sigma_noise is None else sigma_noise
        B = _f32(block["B"]) * self._curv_scale(s)
        if B.dim() != 2:
            raise LaplaceStructureError(
                "KronLaplace: scan-stacked Kronecker factors (B.ndim==3) "
                "are not supported — fit with last_layer=True")
        A = block.get("A", block.get("A_diag"))
        eye_b = torch.eye(B.shape[0], dtype=B.dtype, device=B.device)
        d = _scalar(d, B)
        if A is None:
            return None, B + d * eye_b
        A = _f32(A)
        pi = K.pi_factor(A, B)
        sd = torch.sqrt(d)
        if A.dim() == 1:
            Ad = A + pi * sd
        else:
            Ad = A + pi * sd * torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
        return Ad, B + (sd / pi) * eye_b

    def log_det_ratio(self, prior_prec=None, sigma_noise=None):
        """Closed form: logdet(A'⊗B') = b·logdet A' + a·logdet B'."""
        d = self.prior_prec if prior_prec is None else prior_prec
        terms = []

        def block_ld(mean_leaf, block):
            Ad, Bd = self.damped_factors(block, prior_prec, sigma_noise)
            if Ad is None:
                terms.append(_logdet(Bd))
            else:
                terms.append(Bd.shape[0] * _logdet(Ad) + Ad.shape[0] * _logdet(Bd))

        _map_kron(block_ld, self.mean, self.kron)
        return sum(terms) - self.n_params() * torch.log(_scalar(d, self._like))

    def sample(self, rng, n_samples: int = 1):
        """θ = θ* + A'^{-1/2} E B'^{-1/2} per weight block (matrix normal),
        vec-covariance exactly (A'⊗B')⁻¹; ``rng`` as for
        :meth:`DiagLaplace.sample`."""
        eps = tree_unflatten(self.mean, _normal_draws(rng, self.mean, n_samples))

        def block_sample(mean_leaf, block, e):
            Ad, Bd = self.damped_factors(block)
            m = _f32(mean_leaf)[None]
            SB = _inv_sqrt_psd(Bd)
            if Ad is None:
                return m + torch.einsum("ij,kj->ki", SB, e)
            if Ad.dim() == 1:
                half = e * torch.rsqrt(Ad)[None, :, None]
            else:
                half = torch.einsum("ij,kjl->kil", _inv_sqrt_psd(Ad), e)
            return m + torch.einsum("kil,lm->kim", half, SB)

        return _map_kron(block_sample, self.mean, self.kron, extra=eps)

    def cov_halves(self, block):
        """(L_A, L_B) with L Lᵀ the damped factor inverses — the GLM
        predictive's half-transforms."""
        Ad, Bd = self.damped_factors(block)
        if Ad is None or Ad.dim() == 1:
            raise LaplaceStructureError(
                "KronLaplace predictive needs dense A factors "
                "(Dense/Conv2d weight blocks)")
        return _cov_half(Ad), _cov_half(Bd)

    def bias_cov(self, block):
        _, Bd = self.damped_factors(block)
        return torch.linalg.inv(Bd)

    def layer_blocks(self):
        return self.kron


# ---------------------------------------------------------------------------
# last-layer restriction
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LastLayerLaplace:
    """Laplace posterior over the final Dense layer only: the engine sweep
    runs on the head alone, with the extracted features as inputs."""

    inner: Any        # Diag/Kron posterior over the head params
    full_mean: Any    # full params tree (head included)

    structure: ClassVar[str] = "last_layer"

    @classmethod
    def fit(cls, model, params, x, y, loss, *, structure: str = "kron",
            options: Optional[FitOptions] = None, **legacy):
        o = _merge_fit_options(options, legacy, "LastLayerLaplace.fit")
        feats, head, f_params, h_params = split_last_dense(model, params)
        phi = feats.call(f_params, x)
        inner_cls = {"diag": DiagLaplace, "kron": KronLaplace}.get(structure)
        if inner_cls is None:
            raise LaplaceStructureError(
                f"LastLayerLaplace: unknown structure '{structure}' "
                "(expected 'diag' or 'kron')")
        inner = inner_cls.fit(head, h_params, phi, y, loss, options=o)
        return cls(inner=inner, full_mean=params)

    def features(self, model, params, x):
        feats, _, f_params, _ = split_last_dense(model, params)
        return feats.call(f_params, x)

    def sample(self, rng, n_samples: int = 1):
        """Full params tree with leading axis K: the head sampled (``rng``
        as for the inner posterior's ``sample``, over the head's params),
        the rest tiled."""
        head_samples = self.inner.sample(rng, n_samples)
        base = tree_map(lambda leaf: leaf[None].expand((n_samples,) + tuple(leaf.shape)),
                        tuple(self.full_mean[:-1]))
        return base + (head_samples,)

    def log_det_ratio(self, *a, **kw):
        return self.inner.log_det_ratio(*a, **kw)

    def scatter(self, *a, **kw):
        return self.inner.scatter(*a, **kw)

    def log_lik(self, *a, **kw):
        return self.inner.log_lik(*a, **kw)

    @property
    def likelihood(self):
        return self.inner.likelihood

    @property
    def prior_prec(self):
        return self.inner.prior_prec

    @property
    def sigma_noise(self):
        return self.inner.sigma_noise


def split_last_dense(model, params):
    """(features, head, f_params, h_params) for a Sequential ending in
    Dense — the last-layer Laplace decomposition."""
    if not isinstance(model, Sequential) or not len(model.mods):
        raise LaplaceStructureError(
            "LastLayerLaplace needs a Sequential model "
            f"(got {type(model).__name__})")
    if not isinstance(model.mods[-1], Dense):
        raise LaplaceStructureError(
            "LastLayerLaplace needs the final module to be Dense "
            f"(got {type(model.mods[-1]).__name__}); reorder the head or "
            "use a full-net DiagLaplace/KronLaplace fit")
    feats = Sequential(list(model.mods[:-1]))
    return feats, model.mods[-1], tuple(params[:-1]), params[-1]


# ---------------------------------------------------------------------------
# front door
# ---------------------------------------------------------------------------


def _fit_args(cfg, extensions, rng, mc, default):
    """Default extensions, and a fixed MC seed (``mc_seed=0``) when an MC
    fit gets no draws."""
    cfg = cfg or ExtensionConfig()
    extensions = tuple(extensions) if extensions else default
    needs_mc = any(e.sweep == "ggn_mc" for e in extensions)
    if needs_mc and rng is None and cfg.mc_seed is None:
        cfg = dataclasses.replace(cfg, mc_seed=0)
    return cfg, extensions, rng


def fit_posterior(model, params, x, y, loss, *, structure: str = "diag",
                  last_layer: bool = False, options: Optional[FitOptions] = None,
                  **legacy):
    """Fit a Laplace posterior from one engine sweep.

    Parameters
    ----------
    model, params
        The trained model and its MAP parameters ``θ*``.
    x, y
        Fitting batch: inputs ``[N, ...]`` and targets.
    loss
        ``CrossEntropyLoss`` or ``MSELoss``.
    structure : {'diag', 'kron'}
        Elementwise GGN diagonals (Eq. 19) or π-damped per-layer Kronecker
        blocks (Eq. 23).
    last_layer : bool
        Restrict the posterior to the final Dense layer.
    options : FitOptions
        Everything else (see :class:`FitOptions`); its fields as keywords
        still work with a ``DeprecationWarning``.

    Returns
    -------
    DiagLaplace | KronLaplace | LastLayerLaplace

    Raises
    ------
    LaplaceStructureError
        When the extension set cannot serve ``structure`` or the model lacks
        the layer structure it needs.
    """
    o = _merge_fit_options(options, legacy, "fit_posterior")
    if last_layer:
        return LastLayerLaplace.fit(model, params, x, y, loss, structure=structure,
                                    options=o)
    cls = {"diag": DiagLaplace, "kron": KronLaplace}.get(structure)
    if cls is None:
        raise LaplaceStructureError(
            f"fit_posterior: unknown structure '{structure}' "
            "(expected 'diag' or 'kron')")
    return cls.fit(model, params, x, y, loss, options=o)
