"""The Laplace package of the port held against the JAX package on the CPU.

* ``predictive_var``'s plain version (what ``repro_torch.kernels.ops`` runs
  for CPU tensors) against the JAX registry (Pallas interpret) and oracle,
  with and without ``Sigma``, at small ragged shapes.
* ``fit_posterior`` (diag, kron, last-layer diag and kron) on the mlp and
  c2d2 setups of ``tests/test_laplace.py``: the curvature, ``cov_diag``,
  ``cov_halves`` (as L Lᵀ: eigenvectors carry a free sign), the damped
  factors, ``log_det_ratio``, ``scatter`` and ``log_lik``; ``log_marglik``
  and the ``optimize_marglik`` trajectory; ``glm_predictive`` (the c2d2
  conv layers put the kernel's plain version on the route);
  ``sample`` and ``mc_predictive`` with JAX's own normal draws passed in;
  ``probit_predictive``; and the chain fit → evidence → predictive → probit
  on c2d2 against JAX's chain.

The evidence, ``optimize_marglik``, the GLM and MC predictives and the chain
are in ``tests/test_torch_laplace_predictive.py`` (so that the two files run
on separate workers), the helpers both use in
``tests/_torch_laplace_common.py``.

JAX fits on its plain route (``use_kernels=False``, its default) and, on
c2d2, on its kernel route (Pallas interpret) too; the port names both of its
routing flags.  Parameters cross through numpy (``repro_torch.bridge``),
inputs are made with numpy from a seed.

JAX's diagonal ``log_det_ratio`` is ``Σ log P − P_dim log δ`` in float32,
two sums of 10⁵ terms at c2d2 whose difference cancels to 3e-4 of itself;
the port sums ``log1p(c·M/δ)``.  The diagonal evidence is therefore held
against JAX's formula evaluated in float64 on JAX's fitted curvature
(:func:`_diag_evidence64`), and the diagonal ``optimize_marglik``
trajectory against the same Adam steps taken in float64 on it.

Tolerances: the fit's pieces and the predictive rtol 1e-5 (atol 1e-6 of the
largest entry for the curvature, whose small entries are float32 sums that
cancel); evidence rtol 1e-5; the marglik trajectory rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_laplace_common import (
    PRIOR,
    STRUCTURES,
    _close,
    _diag_evidence64,
    _inner,
    _rand,
    fits,
    setup,
)

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro import laplace as jl
from repro.laplace.posterior import _map_kron as j_map_kron
from repro_torch import laplace as tl
from repro_torch.core import Activation, Dense, ExtensionConfig, Sequential
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels import ops


# ---------------------------------------------------------------------------
# predictive_var: the plain version against the Pallas kernel and oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_sigma", [False, True], ids=["kron", "diag"])
@pytest.mark.parametrize("shape", [(3, 5, 7, 9, 13), (1, 4, 1, 6, 5), (4, 3, 6, 130, 7)],
                         ids=["ragged", "r1", "wide"])
def test_predictive_var_matches_jax(shape, with_sigma):
    c, n, r, a, b = shape
    A, S = _rand(0, n, r, a), _rand(1, c, n, r, b)
    Sigma = np.abs(_rand(2, a, b)) if with_sigma else None
    got = ops.predictive_var(torch.from_numpy(A), torch.from_numpy(S),
                             None if Sigma is None else torch.from_numpy(Sigma))
    j = (jnp.asarray(A), jnp.asarray(S), None if Sigma is None else jnp.asarray(Sigma))
    for want in (jops.predictive_var(*j), jref.predictive_var(*j)):
        _close(got, want, rtol=1e-5)


FIT_PARAMS = [(n, s, False) for n in ("mlp", "c2d2") for s in STRUCTURES] + [
    ("c2d2", s, True) for s in ("diag", "kron")]


@pytest.mark.parametrize("name,structure,jax_kernels", FIT_PARAMS,
                         ids=[f"{n}-{s}-jax_{'kernels' if k else 'plain'}"
                              for n, s, k in FIT_PARAMS])
def test_fit_matches_jax(name, structure, jax_kernels):
    jpost, tpost = fits(name, structure, jax_kernels)
    ji, ti = _inner(jpost), _inner(tpost)
    assert type(tpost).__name__ == type(jpost).__name__
    assert (ti.n_data, ti.likelihood, ti.n_outputs) == (ji.n_data, ji.likelihood, ji.n_outputs)
    np.testing.assert_allclose(ti.loss_map, ji.loss_map, rtol=1e-6)
    _close(tpost.scatter(), jpost.scatter())
    _close(tpost.log_lik(), jpost.log_lik())
    if isinstance(ti, tl.DiagLaplace):
        for c, jc in zip(tree_leaves(ti.curv), jax.tree.leaves(ji.curv), strict=True):
            jc = np.asarray(jc)
            _close(c, jc, atol=1e-6 * np.abs(jc).max())
            _close(ti.cov_diag(c), ji.cov_diag(jc))
        _close(tpost.log_det_ratio(), _diag_evidence64(ji, np.log(PRIOR))[2])
    else:
        blocks = []
        j_map_kron(lambda m, b: blocks.append(b), ji.mean, ji.kron)
        got = []
        tl.posterior._map_kron(lambda m, b: got.append(b), ti.mean, ti.kron)
        assert len(got) == len(blocks)
        for b, jb in zip(got, blocks):
            for (f, jf) in zip(ti.damped_factors(b), ji.damped_factors(jb)):
                if jf is not None:
                    _close(f, jf, atol=1e-6 * np.abs(np.asarray(jf)).max())
            if "A" in b:
                for L, jL in zip(ti.cov_halves(b), ji.cov_halves(jb)):
                    jLLt = np.asarray(jL @ jL.T)
                    _close(L @ L.T, jLLt, atol=1e-5 * np.abs(jLLt).max())
        _close(tpost.log_det_ratio(), jpost.log_det_ratio())


def test_marglik_tunes_sigma_like_jax():
    """Regression: σ is tuned too (``tune_sigma`` defaults to True)."""
    jpost, tpost = fits("mlp_mse", "kron")
    assert tpost.likelihood == "regression"
    _close(tl.log_marglik(tpost, 2.0, 0.7), jl.log_marglik(jpost, 2.0, 0.7))
    _, jres = jl.optimize_marglik(jpost, n_steps=20, lr=0.1)
    _, res = tl.optimize_marglik(tpost, n_steps=20, lr=0.1)
    _close(res.history, jres.history, rtol=1e-4)
    np.testing.assert_allclose((res.prior_prec, res.sigma_noise),
                               (jres.prior_prec, jres.sigma_noise), rtol=1e-4)


F64_PARAMS = [(n, s) for n in ("mlp", "c2d2") for s in STRUCTURES]


@pytest.mark.parametrize("name,structure", F64_PARAMS, ids=[f"{n}-{s}" for n, s in F64_PARAMS])
def test_float64_fit_and_predictive_follow_their_inputs(name, structure):
    """A float64 MAP and batch (the CPU reference of the card's Laplace
    check) fit, weigh the evidence and predict in float64, and agree with
    JAX's float32 chain to its rounding (rtol 1e-4; the diagonal evidence
    against JAX's formula in float64); ``optimize_marglik`` (float32 Adam
    state) still raises the evidence."""
    s = setup(name)
    jpost, _ = fits(name, structure)
    st, last = STRUCTURES[structure]
    p64 = tree_map(lambda v: v.double(), s["tp"])
    y = torch.from_numpy(s["y"])
    y = y.double() if y.is_floating_point() else y
    post = tl.fit_posterior(s["tm"], p64, torch.from_numpy(s["x"]).double(), y, s["tloss"],
                            structure=st, last_layer=last,
                            options=tl.FitOptions(prior_prec=PRIOR))
    inner = _inner(post)
    curv = inner.curv if structure.endswith("diag") else inner.kron
    assert all(leaf.dtype == torch.float64 for leaf in tree_leaves(curv))
    ev = tl.log_marglik(post)
    assert ev.dtype == torch.float64
    ji = _inner(jpost)  # a diagonal evidence in float64 (JAX's cancels in float32)
    _close(ev, _diag_evidence64(ji, np.log(PRIOR))[0] if isinstance(ji, jl.DiagLaplace)
           else jl.log_marglik(jpost), rtol=1e-4)
    mean, var = tl.glm_predictive(s["tm"], p64, post, torch.from_numpy(s["x2"]).double())
    assert mean.dtype == var.dtype == torch.float64
    jmean, jvar = jl.glm_predictive(s["jm"], s["jp"], jpost, jnp.asarray(s["x2"]),
                                    use_kernels=False)
    _close(mean, jmean, rtol=1e-4, atol=1e-6)
    _close(var, jvar, rtol=1e-4)
    tuned, res = tl.optimize_marglik(post, n_steps=5, lr=0.1)
    assert tl.log_marglik(tuned).item() > ev.item()


def test_glm_predictive_calls_predictive_var(monkeypatch):
    """On c2d2 the two conv layers send their variance through
    ops.predictive_var (spied: on the CPU no launch is counted); the dense
    layers take the closed forms, and the last-layer path none."""
    calls = []
    real = ops.predictive_var
    monkeypatch.setattr(ops, "predictive_var", lambda *a: calls.append(a[2] is None) or real(*a))
    s = setup("c2d2")
    x2 = torch.from_numpy(s["x2"])
    for structure in ("diag", "kron", "last_kron"):
        tl.glm_predictive(s["tm"], s["tp"], fits("c2d2", structure)[1], x2)
    assert calls == [False, False, True, True]


def test_sample_from_a_generator():
    _, tpost = fits("mlp", "kron")
    a = tpost.sample(torch.Generator().manual_seed(0), 3)
    b = tpost.sample(torch.Generator().manual_seed(0), 3)
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        assert x.shape[0] == 3
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    with pytest.raises(ValueError, match="draws"):
        tpost.sample([torch.zeros(3, 2)], 3)


MB_PARAMS = [("mlp", "kron", 4), ("mlp", "last_kron", 3), ("c2d2", "diag", 3),
             ("c2d2", "kron", 3)]


@pytest.mark.parametrize("name,structure,mb", MB_PARAMS,
                         ids=[f"{n}-{s}-mb{m}" for n, s, m in MB_PARAMS])
def test_fit_microbatch_matches_jax(name, structure, mb):
    """``FitOptions(microbatch_size=...)``: the fit on the accumulated lane
    against JAX's fit on its accumulated lane, and the port's monolithic
    fit (rtol 3e-5, atol 3e-6 of the largest entry)."""
    s = setup(name)
    st, last = STRUCTURES[structure]
    x, y = torch.from_numpy(s["x"]), torch.from_numpy(s["y"])
    jpost = jl.fit_posterior(s["jm"], s["jp"], jnp.asarray(s["x"]), jnp.asarray(s["y"]),
                             s["jloss"], structure=st, last_layer=last,
                             options=jl.FitOptions(microbatch_size=mb))
    posts = [tl.fit_posterior(s["tm"], s["tp"], x, y, s["tloss"], structure=st,
                              last_layer=last, options=tl.FitOptions(microbatch_size=size))
             for size in (mb, None)]
    ji = _inner(jpost)
    for tpost in posts:
        ti = _inner(tpost)
        np.testing.assert_allclose(ti.loss_map, ji.loss_map, rtol=1e-6)
        tree, jtree = (ti.curv, ji.curv) if st == "diag" else (ti.kron, ji.kron)
        for c, jc in zip(tree_leaves(tree), jax.tree.leaves(jtree), strict=True):
            jc = np.asarray(jc)
            _close(c, jc, rtol=3e-5, atol=3e-6 * np.abs(jc).max())


def test_fit_microbatch_mc_matches_monolithic():
    """An MC fit in slices draws what the monolithic fit draws from one
    ``mc_seed`` (``cfg.microbatch_size`` as the size)."""
    s = setup("c2d2")
    args = (s["tm"], s["tp"], torch.from_numpy(s["x"]), torch.from_numpy(s["y"]), s["tloss"])
    posts = [tl.fit_posterior(*args, structure="diag", options=tl.FitOptions(
        mc=True, cfg=ExtensionConfig(mc_seed=0, microbatch_size=size))) for size in (3, None)]
    for c, w in zip(tree_leaves(posts[0].curv), tree_leaves(posts[1].curv), strict=True):
        _close(c, w, rtol=3e-5, atol=3e-6 * w.abs().max().item())


def test_misconfigured_fits_raise():
    s = setup("mlp")
    args = (s["tm"], s["tp"], torch.from_numpy(s["x"]), torch.from_numpy(s["y"]), s["tloss"])
    with pytest.raises(tl.LaplaceStructureError, match="structure"):
        tl.fit_posterior(*args, structure="full")
    with pytest.raises(tl.LaplaceStructureError, match="cannot serve"):
        tl.fit_posterior(*args, structure="kron",
                         options=tl.FitOptions(extensions=(tl.posterior.DiagGGN,)))
    with pytest.raises(tl.LaplaceStructureError, match="ckpt_dir"):
        tl.fit_posterior(*args, options=tl.FitOptions(ckpt_dir="unused"))
    with pytest.raises(NotImplementedError, match="sharded lane"):
        tl.fit_posterior(*args, options=tl.FitOptions(mesh=object()))
    # microbatch_size no longer raises: the fit runs on the accumulated lane
    mono = tl.fit_posterior(*args, structure="diag")
    mb = tl.fit_posterior(*args, structure="diag", options=tl.FitOptions(microbatch_size=4))
    for c, w in zip(tree_leaves(mb.curv), tree_leaves(mono.curv), strict=True):
        _close(c, w, rtol=3e-5, atol=3e-6)
    with pytest.raises(tl.LaplaceStructureError, match="final module to be Dense"):
        tl.posterior.split_last_dense(Sequential([Dense(3, 2, device="cpu"), Activation("relu")]),
                            ({}, ()))
    with pytest.warns(DeprecationWarning, match="FitOptions"):
        post = tl.fit_posterior(*args, structure="diag", prior_prec=2.0)
    assert post.prior_prec == 2.0
    with pytest.raises(TypeError, match="unexpected keyword"):
        tl.fit_posterior(*args, not_an_option=1)
