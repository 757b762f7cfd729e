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
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import papernets as jnets
from repro.core import CrossEntropyLoss as JCrossEntropy
from repro.core import Dense as JDense
from repro.core import ExtensionConfig as JConfig
from repro.core import MSELoss as JMSE
from repro.core import Sequential as JSequential
from repro.core import Activation as JActivation
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro import laplace as jl
from repro.laplace.posterior import _map_kron as j_map_kron
from repro_torch import laplace as tl
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import papernets as tnets
from repro_torch.core import (
    Activation,
    CrossEntropyLoss,
    Dense,
    ExtensionConfig,
    MSELoss,
    Sequential,
)
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels import ops

STRUCTURES = {"diag": ("diag", False), "kron": ("kron", False),
              "last_diag": ("diag", True), "last_kron": ("kron", True)}
PRIOR = 3.0


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=1e-5, atol=0.0, msg=""):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


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


# ---------------------------------------------------------------------------
# setups: the mlp and c2d2 of tests/test_laplace.py, batches from numpy
# ---------------------------------------------------------------------------

N, D, H, C = 9, 6, 7, 4


def _setup(name):
    rs = np.random.RandomState(1)
    if name == "c2d2":
        jm = jnets.c2d2(n_classes=10, in_ch=1, img=8)
        tm = tnets.c2d2(n_classes=10, in_ch=1, img=8, device="cpu")
        x, x2 = rs.randn(8, 8, 8, 1).astype(np.float32), rs.randn(6, 8, 8, 1).astype(np.float32)
        y, loss = rs.randint(0, 10, 8), "ce"
    else:
        jm = JSequential([JDense(D, H), JActivation("sigmoid"), JDense(H, C)])
        tm = Sequential([Dense(D, H, device="cpu"), Activation("sigmoid"),
                         Dense(H, C, device="cpu")])
        x, x2 = rs.randn(N, D).astype(np.float32), rs.randn(5, D).astype(np.float32)
        if name == "mlp_mse":
            y, loss = rs.randn(N, C).astype(np.float32), "mse"
        else:
            y, loss = rs.randint(0, C, N), "ce"
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(tm, jax.tree.map(np.asarray, jp), "cpu")
    jloss, tloss = (JCrossEntropy(), CrossEntropyLoss()) if loss == "ce" else (JMSE(), MSELoss())
    return dict(jm=jm, jp=jp, tm=tm, tp=tp, x=x, y=y, x2=x2, jloss=jloss, tloss=tloss)


_SETUPS, _FITS = {}, {}


def setup(name):
    if name not in _SETUPS:
        _SETUPS[name] = _setup(name)
    return _SETUPS[name]


def fits(name, structure, jax_kernels=False, use_kernels=True):
    """(JAX posterior, port posterior) of one setup and structure (once)."""
    key = (name, structure, jax_kernels, use_kernels)
    if key not in _FITS:
        s = setup(name)
        st, last = STRUCTURES[structure]
        jpost = jl.fit_posterior(s["jm"], s["jp"], jnp.asarray(s["x"]), jnp.asarray(s["y"]),
                                 s["jloss"], structure=st, last_layer=last,
                                 options=jl.FitOptions(prior_prec=PRIOR,
                                                       cfg=JConfig(use_kernels=jax_kernels)))
        tpost = tl.fit_posterior(s["tm"], s["tp"], torch.from_numpy(s["x"]),
                                 torch.from_numpy(s["y"]), s["tloss"], structure=st,
                                 last_layer=last,
                                 options=tl.FitOptions(prior_prec=PRIOR, cfg=ExtensionConfig(
                                     use_kernels=use_kernels, use_fused=True)))
        _FITS[key] = (jpost, tpost)
    return _FITS[key]


def _inner(post):
    return post.inner if hasattr(post, "inner") else post


def _diag_evidence64(jpost, log_d):
    """JAX's diagonal evidence and its derivative in log δ, in float64 on
    JAX's fitted curvature (classification)."""
    d, m = float(np.exp(log_d)), float(jpost.n_data)
    cs = [np.asarray(c, np.float64) for c in jax.tree.leaves(jpost.curv)]
    sq = sum(np.sum(np.asarray(p, np.float64) ** 2) for p in jax.tree.leaves(jpost.mean))
    ldr = sum(np.sum(np.log(c * m + d)) for c in cs) - sum(c.size for c in cs) * np.log(d)
    dldr = sum(np.sum(-(c * m) / (c * m + d)) for c in cs)
    return -m * jpost.loss_map - 0.5 * (d * sq + ldr), -0.5 * (d * sq + dldr), ldr


def _adam64(jpost, d0, n_steps, lr):
    """optimize_marglik's Adam steps on :func:`_diag_evidence64`."""
    theta, mo, v, hist = np.log(d0), 0.0, 0.0, []
    for t in range(1, n_steps + 1):
        ev, g, _ = _diag_evidence64(jpost, theta)
        g = -g
        mo, v = 0.9 * mo + 0.1 * g, 0.999 * v + 0.001 * g * g
        theta -= lr * (mo / (1 - 0.9 ** t)) / (np.sqrt(v / (1 - 0.999 ** t)) + 1e-8)
        hist.append(ev)
    return np.exp(theta), np.asarray(hist)


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


def test_sample_from_a_generator():
    _, tpost = fits("mlp", "kron")
    a = tpost.sample(torch.Generator().manual_seed(0), 3)
    b = tpost.sample(torch.Generator().manual_seed(0), 3)
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        assert x.shape[0] == 3
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    with pytest.raises(ValueError, match="draws"):
        tpost.sample([torch.zeros(3, 2)], 3)


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
    with pytest.raises(NotImplementedError, match="accumulated lane"):
        tl.fit_posterior(*args, options=tl.FitOptions(microbatch_size=4))
    with pytest.raises(tl.LaplaceStructureError, match="final module to be Dense"):
        tl.posterior.split_last_dense(Sequential([Dense(3, 2, device="cpu"), Activation("relu")]),
                            ({}, ()))
    with pytest.warns(DeprecationWarning, match="FitOptions"):
        post = tl.fit_posterior(*args, structure="diag", prior_prec=2.0)
    assert post.prior_prec == 2.0
    with pytest.raises(TypeError, match="unexpected keyword"):
        tl.fit_posterior(*args, not_an_option=1)
