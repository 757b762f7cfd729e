"""Kernel-space natural gradient: solve in [N·C̃] Gram space, not [P].

For the damped GGN ``F = J'ᵀJ' + δI`` (``J' = √Hᵀ J``, the loss-scaled
half-sandwich Jacobian of the Dense-visible parameters), the Woodbury
identity moves the solve into sample space:

    F⁻¹ g = (1/δ) [ g − J'ᵀ (K + δI)⁻¹ J' g ],    K = J' J'ᵀ  [N·C̃, N·C̃]

When ``N·C̃ ≪ P`` the only dense object is the Gram matrix ``K``, assembled
by the engine's ``ggn_gram`` extension (one extra backward sweep, its inner
J·Jᵀ through the ``cross_dot`` kernel on the card), and the parameter-space
work is one Jacobian-vector and one vector-Jacobian product
(``torch.func.jvp`` / ``torch.func.vjp`` over ``model.call``).  Parameters
outside the Gram's coverage see ``F = δI``: their direction is ``g/δ``.

Port of ``src/repro/curv/ngd.py``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.engine import gram_total, run
from repro_torch.core.extensions import ExtensionConfig, GGNGram
from repro_torch.core.loss_hessian import _f32
from repro_torch.core.tree import tree_map


def _covered(params, gram_tree):
    """Params-shaped tree of bools: does this leaf have a Gram block?"""
    def rec(p, s):
        if isinstance(p, dict):
            return {k: rec(p[k], s.get(k) if isinstance(s, dict) else None) for k in p}
        if isinstance(p, (tuple, list)):
            s_t = s if isinstance(s, (tuple, list)) else (None,) * len(p)
            return tuple(rec(pi, si) for pi, si in zip(p, s_t))
        return s is not None and not (isinstance(s, tuple) and not s)

    return rec(params, gram_tree)


def _mask_to(tree, mask):
    return tree_map(lambda t, m: t if m else torch.zeros_like(t), tree, mask)


def kernel_ngd_direction(model, params, inputs, targets, loss, *, damping: float,
                         cfg: Optional[ExtensionConfig] = None, rng=None, grads=None,
                         results=None):
    """Natural-gradient direction ``(G + δI)⁻¹ ∇L`` by the Gram-space solve.

    Runs one engine sweep with ``ggn_gram`` (skipped when the ``results`` of
    such a sweep are passed in), solves the dense ``[N·C̃, N·C̃]`` system with
    ``torch.linalg.solve``, and maps back with one jvp and one vjp.  Flat
    ``[N, C]`` model outputs only.  Returns ``(direction, results)``.
    """
    cfg = cfg or ExtensionConfig()
    res = results
    if res is None:
        res = run(model, params, inputs, targets, loss, extensions=(GGNGram,), cfg=cfg,
                  rng=rng)
    z = res.logits
    if z.dim() != 2:
        raise ValueError(
            "kernel-space NGD needs flat [N, C] model outputs, got logits "
            f"of shape {tuple(z.shape)} — use the CG lane for sequence models")
    g = grads if grads is not None else res.grads
    delta = float(damping)

    K = gram_total(res.ext["ggn_gram"])                      # [N, N, C̃, C̃]
    n, _, c, _ = K.shape
    K2 = K.permute(0, 2, 1, 3).reshape(n * c, n * c)

    mask = _covered(params, res.ext["ggn_gram"])
    g_cov = _mask_to(g, mask)
    primals = tree_map(lambda p: p.detach(), params)

    def f(p):
        return model.call(p, inputs)

    zz, Jg = torch.func.jvp(f, (primals,), (g_cov,))
    S = _f32(loss.sqrt_hessian(zz, targets))              # [C̃, N, C]
    w = torch.einsum("cnz,nz->nc", S, _f32(Jg)).reshape(n * c)   # J' g
    q = torch.linalg.solve(
        K2 + delta * torch.eye(n * c, dtype=K2.dtype, device=K2.device), w).reshape(n, c)
    v_z = torch.einsum("cnz,nc->nz", S, q)                    # √H (·)
    _, vjp_fn = torch.func.vjp(f, primals)
    (t,) = vjp_fn(v_z.to(zz.dtype))
    t_cov = _mask_to(t, mask)
    d = tree_map(lambda gi, ti: (_f32(gi) - _f32(ti)) / delta, g, t_cov)
    return d, res
