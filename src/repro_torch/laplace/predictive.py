"""Posterior predictives: linearized (GLM) and MC-sampled.

The GLM predictive linearizes the network at the MAP estimate, so the
function-space predictive is Gaussian with

    mean   = f(x; θ*)                      [N, C]
    var    = diag(J(x) Σ J(x)ᵀ)            [N, C]

with ``J`` the output/parameter Jacobian and ``Σ`` the Laplace covariance.
``J`` comes the BackPACK way: the engine's factor sweep with the identity
over outputs, ``S₀[c] = e_c``, gives at every Dense-shaped layer the pair
``(A, S)`` whose contraction is the layer's Jacobian tile
``J[c,n] = Σ_r a_{n,r} s_{c,n,r}ᵀ``.  Contracting the tiles against ``Σ``
is the ``predictive_var`` kernel, which never forms ``[C, N, a, b]``:

* diagonal Σ: the kernel weights the squared tile by the covariance
  diagonal ``Sigma [a, b]``;
* Kronecker Σ = (A'⁻¹ ⊗ B'⁻¹): the inputs are half-transformed outside the
  kernel (``Ã = A L_A``, ``S̃ = S L_B``, ``torch.matmul``) and the quadratic
  form is ``‖J̃‖²_F``, the same kernel without the weight.

Rank-1 layers (R == 1) take closed forms; ``use_kernels=False`` keeps the
plain per-sample-Jacobian einsum.  Port of
``src/repro/laplace/predictive.py``.
"""
from __future__ import annotations

import math

import torch

from repro_torch import obs
from repro_torch.core.loss_hessian import _f32_dtype
from repro_torch.core.module import Dense, Sequential, _f32, _nra
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.nn.layers import Conv2d

from .posterior import (
    DiagLaplace,
    KronLaplace,
    LaplaceStructureError,
    LastLayerLaplace,
    split_last_dense,
)


def _output_factor(z):
    """Identity Jacobian seed over outputs: S₀ [C, N, C], S₀[c,n,:] = e_c."""
    if z.dim() != 2:
        raise LaplaceStructureError(
            f"glm_predictive needs [N, C] outputs (got shape {tuple(z.shape)}); "
            "for sequence models slice features to one position and use the "
            "last-layer posterior's head directly")
    n, c = z.shape
    eye = torch.eye(c, dtype=_f32_dtype(z), device=z.device)
    return eye[:, None, :].expand(c, n, c)


# ---------------------------------------------------------------------------
# per-layer variance contributions
# ---------------------------------------------------------------------------


def _variance(A, S, Sigma, use_kernels):
    """Σ_ab (A_nᵀS_cn)² [· Sigma]: the kernel, or its plain version."""
    if use_kernels:
        return kops.predictive_var(A.contiguous(), S.contiguous(),
                                   None if Sigma is None else Sigma.contiguous())
    return ref.predictive_var(A, S, Sigma)


def _diag_weight_var(cov_w, A, Sr, use_kernels):
    """Σ_{ij} J[c,n,i,j]² σ²[i,j] for J = Σ_r a sᵀ."""
    Af, Sf = _f32(A), _f32(Sr)
    if A.shape[1] == 1:
        # Rank-1 closed form: J = a sᵀ separates.
        return torch.einsum("na,ab,cnb->cn", Af[:, 0] ** 2, cov_w, Sf[:, :, 0] ** 2)
    return _variance(Af, Sf, cov_w, use_kernels)


def _kron_weight_var(LA, LB, A, Sr, use_kernels):
    """‖L_Aᵀ J L_B‖²_F via half-transformed inputs (see the module doc)."""
    At = _f32(A) @ LA
    St = _f32(Sr) @ LB
    if A.shape[1] == 1:
        return (At[:, 0] ** 2).sum(-1)[None] * (St[:, :, 0] ** 2).sum(-1)
    return _variance(At, St, None, use_kernels)


def _layer_var(post, blocks, A, Sr, bias, use_kernels):
    """Variance contribution [C, N] of one Dense-shaped layer."""
    if isinstance(post, DiagLaplace):
        var = _diag_weight_var(post.cov_diag(blocks["w"]), A, Sr, use_kernels)
        if bias:
            ssum = _f32(Sr).sum(dim=2)  # [C, N, b]
            var = var + torch.einsum("cnb,b->cn", ssum * ssum, post.cov_diag(blocks["b"]))
        return var
    if isinstance(post, KronLaplace):
        LA, LB = post.cov_halves(blocks["w"])
        var = _kron_weight_var(LA, LB, A, Sr, use_kernels)
        if bias:
            ssum = _f32(Sr).sum(dim=2)
            var = var + torch.einsum("cni,ij,cnj->cn", ssum, post.bias_cov(blocks["b"]), ssum)
        return var
    raise LaplaceStructureError(
        f"glm_predictive: unsupported posterior {type(post).__name__}")


def _var_sweep(module, params, tape, S, blocks, post, use_kernels, var):
    """Backward Jacobian-factor sweep accumulating per-layer variance."""
    if isinstance(module, Dense):
        A = _nra(tape)
        c = S.shape[0]
        Sr = S.reshape((c,) + tuple(A.shape[:2]) + (module.d_out,))
        var = var + _layer_var(post, blocks, A, Sr, module.use_bias, use_kernels)
        return module.jac_t_mat(params, tape, S), var
    if isinstance(module, Conv2d):
        pat, _ = tape  # the patches [N, H'·W', kh·kw·C_in]: the layer's A
        c = S.shape[0]
        Sr = S.reshape(c, S.shape[1], -1, module.c_out)
        var = var + _layer_var(post, blocks, pat, Sr, module.use_bias, use_kernels)
        return module.jac_t_mat(params, tape, S), var
    if not tree_leaves(params):
        # Parameter-free module: propagate the factor, no contribution.
        return module.jac_t_mat(params, tape, S), var
    if isinstance(module, Sequential):
        for m, p, t, blk in reversed(list(zip(module.mods, params, tape, blocks))):
            S, var = _var_sweep(m, p, t, S, blk, post, use_kernels, var)
        return S, var
    raise LaplaceStructureError(
        f"glm_predictive: unsupported parameterized module "
        f"{type(module).__name__} in a full-net sweep; fit with "
        "last_layer=True instead")


# ---------------------------------------------------------------------------
# public predictives
# ---------------------------------------------------------------------------


def _dense_glm_closed_form(head, params, post, x):
    """GLM predictive of a bare Dense head, without the identity seed: the
    head Jacobian at sample n is rank-1 (``x_n ⊗ e_c``), so the variance is
    a bilinear form in O(N·a·C) memory."""
    z = head.call(params, x)
    xf = _f32(x)
    blocks = post.layer_blocks()
    if isinstance(post, DiagLaplace):
        var = (xf * xf) @ post.cov_diag(blocks["w"])        # [N, C]
        if head.use_bias:
            var = var + post.cov_diag(blocks["b"])[None]
        return z, var
    if isinstance(post, KronLaplace):
        LA, LB = post.cov_halves(blocks["w"])
        q = ((xf @ LA) ** 2).sum(-1)                         # x Acov xᵀ, [N]
        b_diag = (LB * LB).sum(-1)                           # diag(Bcov), [C]
        var = q[:, None] * b_diag[None]
        if head.use_bias:
            var = var + torch.diagonal(post.bias_cov(blocks["b"]))[None]
        return z, var
    raise LaplaceStructureError(
        f"glm_predictive: unsupported posterior {type(post).__name__}")


@torch.no_grad()
def glm_predictive(model, params, posterior, x, *, use_kernels: bool = True):
    """Linearized (GLM) posterior predictive.

    Parameters
    ----------
    model, params
        The model and the MAP parameters the posterior was fitted around.
        For :class:`LastLayerLaplace` the feature extractor runs once and the
        head predictive takes the closed form.
    posterior
        A fitted ``DiagLaplace`` / ``KronLaplace`` / ``LastLayerLaplace``.
    x : Tensor
        Inputs ``[N, ...]``.
    use_kernels : bool
        Contract the Jacobian tiles through ``kernels.ops.predictive_var``
        (the Hopper kernel on CUDA tensors, its plain version on CPU
        tensors); ``False`` keeps the plain per-sample-Jacobian einsum.

    Returns
    -------
    mean : Tensor ``[N, C]``
        MAP outputs.
    var : Tensor ``[N, C]``
        Function-space predictive variance ``diag(J Σ Jᵀ)``; feed both
        through :func:`probit_predictive` for class probabilities.
    """
    if isinstance(posterior, LastLayerLaplace):
        feats, head, f_params, h_params = split_last_dense(model, params)
        phi = feats.call(f_params, x)
        return glm_predictive(head, h_params, posterior.inner, phi, use_kernels=use_kernels)
    if isinstance(model, Dense) and x.dim() == 2:
        return _dense_glm_closed_form(model, params, posterior, x)
    with obs.span("laplace/predictive/glm", n=x.shape[0], use_kernels=use_kernels):
        z, tape = model.forward_tape(params, x)
        S0 = _output_factor(z)
        var0 = torch.zeros((z.shape[-1], z.shape[0]), dtype=_f32_dtype(z), device=z.device)
        _, var = _var_sweep(model, params, tape, S0, posterior.layer_blocks(), posterior,
                            use_kernels, var0)
        return z, var.T


@torch.no_grad()
def mc_predictive(model, params, posterior, x, rng, n_samples: int = 30):
    """Monte-Carlo predictive over posterior weight samples: (mean [N, C],
    variance [N, C]) of the sampled outputs.  ``rng`` is what the
    posterior's ``sample`` takes (a ``torch.Generator`` or the draws)."""
    with obs.span("laplace/predictive/mc", n=x.shape[0], n_samples=n_samples):
        thetas = posterior.sample(rng, n_samples)
        zs = torch.stack([_f32(model.call(tree_map(lambda leaf, k=k: leaf[k], thetas), x))
                          for k in range(n_samples)])
        return zs.mean(dim=0), zs.var(dim=0, unbiased=False)


def probit_predictive(mean, var):
    """MacKay's probit-corrected softmax: the closed-form approximation of
    E[softmax(f)] under f ~ N(mean, diag(var))."""
    kappa = torch.rsqrt(1.0 + (math.pi / 8.0) * _f32(var))
    return torch.softmax(_f32(mean) * kappa, dim=-1)
