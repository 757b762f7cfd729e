"""Helpers shared by ``tests/test_torch_laplace.py`` and
``tests/test_torch_laplace_predictive.py``: the mlp and c2d2 setups of
``tests/test_laplace.py`` with batches from numpy, the JAX and port
posteriors fitted once a process (``fits``), and the diagonal evidence and
its Adam steps in float64 on JAX's fitted curvature (see the first file's
docstring for why)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import papernets as jnets
from repro.core import CrossEntropyLoss as JCrossEntropy
from repro.core import Dense as JDense
from repro.core import ExtensionConfig as JConfig
from repro.core import MSELoss as JMSE
from repro.core import Sequential as JSequential
from repro.core import Activation as JActivation
from repro import laplace as jl
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
