"""The Laplace package's evidence, its optimizer and the predictives held
against the JAX package on the CPU (moved unchanged from
``tests/test_torch_laplace.py``, which keeps the fits, ``predictive_var``
and the rest, so that the two run on separate workers):

* ``log_marglik`` and the ``optimize_marglik`` trajectory (the diagonal
  ones against JAX's formula in float64, ``_diag_evidence64``);
* ``glm_predictive`` and ``probit_predictive`` on both kernel routes;
* ``sample`` and ``mc_predictive`` with JAX's own normal draws passed in;
* the chain fit → evidence → predictive → probit on c2d2 against JAX's.

Tolerances as in ``tests/test_torch_laplace.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_laplace_common import (
    PRIOR,
    STRUCTURES,
    _adam64,
    _close,
    _diag_evidence64,
    _inner,
    fits,
    setup,
)

from repro.core import ExtensionConfig as JConfig
from repro import laplace as jl
from repro.laplace.posterior import _map_kron as j_map_kron
from repro_torch import laplace as tl
from repro_torch.core import ExtensionConfig
from repro_torch.core.tree import tree_leaves


@pytest.mark.parametrize("structure", ["diag", "kron", "last_kron"])
@pytest.mark.parametrize("name", ["mlp", "c2d2"])
def test_marglik_and_its_optimizer_match_jax(name, structure):
    jpost, tpost = fits(name, structure)
    ji = _inner(jpost)
    diag = isinstance(ji, jl.DiagLaplace)
    for d in (0.3, PRIOR, 20.0):
        want = (_diag_evidence64(ji, np.log(d))[0] if diag
                else float(jl.log_marglik(jpost, d)))
        _close(tl.log_marglik(tpost, d), want, msg=f"delta={d}")
    tuned, res = tl.optimize_marglik(tpost, n_steps=25, lr=0.2)
    if diag:
        want_d, want_hist = _adam64(ji, PRIOR, 25, 0.2)
    else:
        jtuned, jres = jl.optimize_marglik(jpost, n_steps=25, lr=0.2)
        want_d, want_hist = jres.prior_prec, jres.history
    _close(res.history, want_hist, rtol=1e-4)
    np.testing.assert_allclose(res.prior_prec, want_d, rtol=1e-4)
    assert tuned.prior_prec == res.prior_prec
    assert float(tl.log_marglik(tuned)) > float(tl.log_marglik(tpost))


GLM_PARAMS = [(n, s, k) for n in ("mlp", "c2d2") for s in STRUCTURES for k in (False, True)]


@pytest.mark.parametrize("name,structure,use_kernels", GLM_PARAMS,
                         ids=[f"{n}-{s}-{'kernels' if k else 'einsum'}"
                              for n, s, k in GLM_PARAMS])
def test_glm_predictive_matches_jax(name, structure, use_kernels):
    s = setup(name)
    jpost, tpost = fits(name, structure)
    jmean, jvar = jl.glm_predictive(s["jm"], s["jp"], jpost, jnp.asarray(s["x2"]),
                                    use_kernels=False)
    mean, var = tl.glm_predictive(s["tm"], s["tp"], tpost, torch.from_numpy(s["x2"]),
                                  use_kernels=use_kernels)
    _close(mean, jmean, atol=1e-6)
    _close(var, jvar)
    assert (var > 0).all()
    _close(tl.probit_predictive(mean, var), jl.probit_predictive(jmean, jvar), atol=1e-7)
    _close(tl.probit_predictive(mean, var).sum(-1), np.ones(len(s["x2"])))


def _jax_diag_draws(jpost, key, k):
    leaves, treedef = jax.tree_util.tree_flatten(jpost.mean)
    keys = jax.random.split(key, len(leaves))
    return jax.tree_util.tree_unflatten(treedef, [
        np.array(jax.random.normal(kk, (k,) + m.shape, jnp.float32))
        for m, kk in zip(leaves, keys)])


def _jax_kron_draws(jpost, key, k):
    counter = [0]

    def draw(mean_leaf, block):
        kk = jax.random.fold_in(key, counter[0])
        counter[0] += 1
        return np.array(jax.random.normal(kk, (k,) + mean_leaf.shape, jnp.float32))

    return j_map_kron(draw, jpost.mean, jpost.kron)


@pytest.mark.parametrize("structure", ["diag", "kron", "last_diag", "last_kron"])
@pytest.mark.parametrize("name", ["mlp", "c2d2"])
def test_sample_and_mc_predictive_match_jax(name, structure):
    s = setup(name)
    jpost, tpost = fits(name, structure)
    key, k = jax.random.PRNGKey(3), 6
    ji = _inner(jpost)
    draws = (_jax_diag_draws(ji, key, k) if isinstance(ji, jl.DiagLaplace)
             else _jax_kron_draws(ji, key, k))
    jthetas = jpost.sample(key, k)
    thetas = tpost.sample(draws, k)
    for a, b in zip(tree_leaves(thetas), jax.tree.leaves(jthetas), strict=True):
        # A'^{-1/2} and B'^{-1/2} are eigh sums whose terms cancel.
        _close(a, b, atol=1e-5 * np.abs(np.asarray(b)).max())
    jmean, jvar = jl.mc_predictive(s["jm"], s["jp"], jpost, jnp.asarray(s["x2"]), key, k)
    mean, var = tl.mc_predictive(s["tm"], s["tp"], tpost, torch.from_numpy(s["x2"]), draws, k)
    # The outputs carry the samples' rounding, scaled by the largest output.
    _close(mean, jmean, atol=1e-5 * np.abs(np.asarray(jmean)).max())
    _close(var, jvar, rtol=1e-4, atol=1e-5 * np.abs(np.asarray(jvar)).max())


def test_fit_to_predictive_chain_matches_jax():
    """The slice end to end on c2d2: fit a Kronecker posterior with the
    kernel route named, tune δ on the evidence, predict on held-out inputs,
    and turn the predictive into class probabilities — against JAX's chain
    (JAX on its Pallas kernels too)."""
    s = setup("c2d2")
    x, y, x2 = (jnp.asarray(s[k]) for k in ("x", "y", "x2"))
    jpost = jl.fit_posterior(s["jm"], s["jp"], x, y, s["jloss"], structure="kron",
                             options=jl.FitOptions(prior_prec=1.0,
                                                   cfg=JConfig(use_kernels=True)))
    jpost, jres = jl.optimize_marglik(jpost, n_steps=15, lr=0.3)
    jprobs = jl.probit_predictive(*jl.glm_predictive(s["jm"], s["jp"], jpost, x2))
    post = tl.fit_posterior(s["tm"], s["tp"], torch.from_numpy(s["x"]), torch.from_numpy(s["y"]),
                            s["tloss"], structure="kron",
                            options=tl.FitOptions(prior_prec=1.0, cfg=ExtensionConfig(
                                use_kernels=True, use_fused=True)))
    post, res = tl.optimize_marglik(post, n_steps=15, lr=0.3)
    probs = tl.probit_predictive(*tl.glm_predictive(s["tm"], s["tp"], post,
                                                    torch.from_numpy(s["x2"]),
                                                    use_kernels=True))
    _close(res.history, jres.history, rtol=1e-4)
    np.testing.assert_allclose(res.prior_prec, jres.prior_prec, rtol=1e-4)
    _close(probs, jprobs, rtol=1e-5, atol=1e-7)
