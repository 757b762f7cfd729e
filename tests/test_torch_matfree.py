"""The port's matrix-free curvature lane held against the JAX package's on the CPU.

* ``loss.hessian_vec`` (CE with a mask, MSE with M counted as JAX counts it)
  and ``_ScaledLoss``'s 1/M_local → 1/M_global ratio;
* ``ggn_vp`` / ``hvp`` for CE and MSE on ``_oracles.tiny_mlp`` and a small
  c2d2 (conv and max-pool under forward mode), monolithic and
  streamed at k ∈ {2, 3} (uneven final slices), against JAX's monolithic
  product; the operators' ``mv`` / ``mv_stacked`` / ``dim`` with damping,
  and ⟨u, Hv⟩ = ⟨Hu, v⟩;
* ``cg_solve``, single, preconditioned and batched: the same iteration
  count as JAX's loop and the same solution;
* ``lanczos_tridiag`` / ``lanczos_topk`` with JAX's start vector, and
  ``slq_logdet`` with JAX's Rademacher probes passed in;
* ``log_marglik_matfree`` (CE and MSE) with JAX's probes;
* ``make_cg_ngd_step``: one step with each solver, monolithic and streamed;
* the refusals: ``mesh=`` (ROADMAP queue A item 12), an unknown solver, the
  whole-step optimizer's ``update``, bad probe shapes, ``k`` > dim.

Parameters are initialised in JAX and cross by numpy
(``repro_torch.bridge``).  Tolerances: products and operators
``_oracles.TOL`` (rtol = atol = 3e-5), streamed or not; CG solutions,
Lanczos and SLQ rtol 1e-4 (float32 recurrences in another summation
order); the NGD step's update rtol 1e-4 with an atol of 1e-4 of its largest
entry.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from _oracles import TOL, tiny_mlp
from repro.configs import papernets as jnets
from repro.core import CrossEntropyLoss as JCrossEntropy
from repro.core import ExtensionConfig as JConfig
from repro.core import MSELoss as JMSE
from repro.core.engine import _ScaledLoss as JScaledLoss
from repro.curv import GGNOperator as JGGNOperator
from repro.curv import HessianOperator as JHessianOperator
from repro.curv import cg_solve as jcg_solve
from repro.curv import ggn_vp as jggn_vp
from repro.curv import hvp as jhvp
from repro.curv import lanczos_topk as jlanczos_topk
from repro.curv import lanczos_tridiag as jlanczos_tridiag
from repro.curv import slq_logdet as jslq_logdet
from repro.laplace import log_marglik_matfree as jlog_marglik_matfree
from repro.optim.matfree import make_cg_ngd_step as jmake_cg_ngd_step
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import papernets as tnets
from repro_torch.core import (Activation, CrossEntropyLoss, Dense, ExtensionConfig, MSELoss,
                              Sequential)
from repro_torch.core.engine import _ScaledLoss
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.curv import (
    GGNOperator,
    HessianOperator,
    cg_solve,
    ggn_vp,
    hvp,
    lanczos_topk,
    lanczos_tridiag,
    slq_logdet,
)
from repro_torch.laplace import log_marglik_matfree
from repro_torch.optim import make_cg_ngd_step

RTOL = dict(rtol=1e-4, atol=1e-5)


@dataclasses.dataclass
class Setup:
    jmodel: object
    jparams: object
    model: object
    params: object
    x: np.ndarray
    y: np.ndarray
    jloss: object
    loss: object


def _port_tiny(d=5, h=7, c=3):
    return Sequential([Dense(d, h, device="cpu"), Activation("tanh"), Dense(h, c, device="cpu")])


_SETUPS = {}


def setup(net, loss="ce"):
    """JAX and port model, params and batch for one net (made once)."""
    if (net, loss) in _SETUPS:
        return _SETUPS[net, loss]
    if net == "tiny":
        jmodel, jparams, x, y = tiny_mlp()
        model = _port_tiny()
    elif net == "mlp":
        jmodel = jnets.mlp(n_classes=3, in_dim=6, hidden=(8,))
        model = tnets.mlp(n_classes=3, in_dim=6, hidden=(8,), device="cpu")
        jparams = jmodel.init(jax.random.PRNGKey(0))
        x = jax.random.normal(jax.random.PRNGKey(1), (12, 6))
        y = jax.random.randint(jax.random.PRNGKey(2), (12,), 0, 3)
    else:
        jmodel = jnets.c2d2(n_classes=4, img=8)
        model = tnets.c2d2(n_classes=4, img=8, device="cpu")
        jparams = jmodel.init(jax.random.PRNGKey(0))
        x = jax.random.normal(jax.random.PRNGKey(1), (5, 8, 8, 1))
        y = jax.random.randint(jax.random.PRNGKey(2), (5,), 0, 4)
    if loss == "mse":
        c = jax.eval_shape(lambda p: jmodel.apply(p, x), jparams).shape[-1]
        y = jax.random.normal(jax.random.PRNGKey(3), (x.shape[0], c))
    params = params_from_numpy(model, jax.tree.map(np.asarray, jparams), "cpu")
    s = Setup(jmodel, jparams, model, params, np.asarray(x), np.asarray(y),
              JCrossEntropy() if loss == "ce" else JMSE(),
              CrossEntropyLoss() if loss == "ce" else MSELoss())
    _SETUPS[net, loss] = s
    return s


def _tangent(s, seed, batch=None):
    """A JAX tangent tree like the params (``[batch, ...]`` leaves when
    given) and the port's copy of it."""
    flat, unravel = ravel_pytree(s.jparams)
    shape = flat.shape if batch is None else (batch,) + flat.shape
    raw = jax.random.normal(jax.random.PRNGKey(seed), shape)
    jv = unravel(raw) if batch is None else jax.vmap(unravel)(raw)
    return jv, _to_port(s.params, jv)


def _to_port(like, jtree):
    return tree_unflatten(like, [torch.tensor(np.asarray(a)) for a in jax.tree.leaves(jtree)])


def _flat(tree):
    """A port or a JAX tree raveled to one numpy vector (leaves in order)."""
    leaves = tree_leaves(tree)
    if not isinstance(leaves[0], torch.Tensor):
        leaves = jax.tree.leaves(tree)
    return np.concatenate([np.asarray(a).reshape(-1) for a in leaves])


def _batch(s):
    y = torch.tensor(s.y)
    return torch.tensor(s.x), (y if y.dtype.is_floating_point else y.long())


# ---------------------------------------------------------------------------
# the loss Hessian in logit space
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("loss", ["ce", "ce_masked", "mse"])
def test_hessian_vec_matches_jax(loss):
    rs = np.random.RandomState(0)
    z = rs.randn(6, 3, 5).astype(np.float32)
    v = rs.randn(6, 3, 5).astype(np.float32)
    if loss == "mse":
        y = rs.randn(6, 3, 5).astype(np.float32)
        jl, tl = JMSE(), MSELoss()
    else:
        y = rs.randint(0, 5, (6, 3))
        if loss == "ce_masked":
            y[0, 1] = y[4, 0] = -1
        jl, tl = JCrossEntropy(), CrossEntropyLoss()
    zt, yt, vt = map(torch.tensor, (z, y, v))
    want = jl.hessian_vec(jnp.asarray(z), jnp.asarray(y), jnp.asarray(v))
    np.testing.assert_allclose(tl.hessian_vec(zt, yt, vt).numpy(), want, **TOL)
    # a slice of 2 of the batch's 6 samples: its 1/M_local becomes 1/M_global
    m_all = jl.num_units(jnp.asarray(y))
    want = JScaledLoss(jl, total_units=m_all).hessian_vec(
        jnp.asarray(z[:2]), jnp.asarray(y[:2]), jnp.asarray(v[:2]))
    got = _ScaledLoss(tl, tl.num_units(yt)).hessian_vec(zt[:2], yt[:2], vt[:2])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# products and operators
# ---------------------------------------------------------------------------

_PRODUCTS = {}  # JAX's monolithic products, computed once
PRODUCTS = [(net, loss, fn, k) for net, loss in (("tiny", "ce"), ("tiny", "mse"),
                                                 ("c2d2", "ce"))
            for fn in ("ggn_vp", "hvp") for k in (1, 2, 3)]


@pytest.mark.parametrize("net,loss,fn,k", PRODUCTS,
                         ids=[f"{n}-{lo}-{f}-k{k}" for n, lo, f, k in PRODUCTS])
def test_product_matches_jax(net, loss, fn, k):
    """The port's product, monolithic (k = 1) or streamed over slices of k
    samples (an uneven last slice: N = 11, 12 and 5), against JAX's
    monolithic product."""
    s = setup(net, loss)
    jv, v = _tangent(s, 4)
    tfn = ggn_vp if fn == "ggn_vp" else hvp
    if (net, loss, fn) not in _PRODUCTS:
        jfn = jggn_vp if fn == "ggn_vp" else jhvp
        go = jax.jit(lambda p, xx, yy, t: jfn(s.jmodel, p, xx, yy, s.jloss, t))
        _PRODUCTS[net, loss, fn] = _flat(go(s.jparams, jnp.asarray(s.x), jnp.asarray(s.y), jv))
    want = _PRODUCTS[net, loss, fn]
    x, y = _batch(s)
    cfg = ExtensionConfig(microbatch_size=k) if k > 1 else None
    got = _flat(tfn(s.model, s.params, x, y, s.loss, v, cfg=cfg))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kind", ["ggn", "hessian"])
def test_operators_match_jax(kind):
    s = setup("tiny")
    J, T = (JGGNOperator, GGNOperator) if kind == "ggn" else (JHessianOperator, HessianOperator)
    x, y = _batch(s)
    jop = J(s.jmodel, s.jparams, jnp.asarray(s.x), jnp.asarray(s.y), s.jloss, damping=0.3)
    op = T(s.model, s.params, x, y, s.loss, damping=0.3)
    assert op.dim == jop.dim == 66
    jv, v = _tangent(s, 5)
    np.testing.assert_allclose(_flat(op.mv(v)), _flat(jax.jit(jop.mv)(jv)), **TOL)
    jV, V = _tangent(s, 6, batch=3)
    got, want = op.mv_stacked(V), jax.jit(jop.mv_stacked)(jV)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want), strict=True):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # symmetric: <u, A w> = <A u, w>
    _, u = _tangent(s, 7)
    uaw = float(np.dot(_flat(op.mv(v)), _flat(u)))
    awu = float(np.dot(_flat(op.mv(u)), _flat(v)))
    assert uaw == pytest.approx(awu, rel=1e-5)


# ---------------------------------------------------------------------------
# conjugate gradients
# ---------------------------------------------------------------------------

CG = {"single": dict(batched=False), "preconditioned": dict(batched=False, precond=True),
      "batched": dict(batched=True), "budget": dict(batched=False, tol=0.0, maxiter=7)}


@pytest.mark.parametrize("case", CG)
def test_cg_matches_jax(case):
    """Same iteration count as JAX's while_loop, same solution.  The two
    recurrences agree to ~1e-5 of the residual down to ~1e-4 and part at
    float32's floor (~1e-5); tol 2e-4 is crossed between iterations 9 and 10
    with a margin of 1.6x or more on both sides.  The budget case stops at
    maxiter."""
    kw = dict(CG[case])
    tol, maxiter = kw.pop("tol", 2e-4), kw.pop("maxiter", 200)
    s = setup("tiny")
    x, y = _batch(s)
    jop = JGGNOperator(s.jmodel, s.jparams, jnp.asarray(s.x), jnp.asarray(s.y), s.jloss,
                       damping=0.1)
    op = GGNOperator(s.model, s.params, x, y, s.loss, damping=0.1)
    batched = kw["batched"]
    jb, b = _tangent(s, 8, batch=3 if batched else None)
    jpre = pre = None
    if kw.get("precond"):
        def jpre(r):
            return jax.tree.map(lambda t: t * 0.5, r)

        def pre(r):
            return tree_map(lambda t: t * 0.5, r)
    want = jax.jit(lambda rhs: jcg_solve(jop.mv_stacked if batched else jop.mv, rhs, tol=tol,
                                         maxiter=maxiter, precond=jpre, batched=batched))(jb)
    got = cg_solve(op.mv_stacked if batched else op.mv, b, tol=tol, maxiter=maxiter,
                   precond=pre, batched=batched)
    assert got.iters == int(want.iters) and 0 < got.iters <= maxiter
    np.testing.assert_allclose(_flat(got.x), _flat(want.x), **RTOL)
    np.testing.assert_allclose(got.resid.numpy(), np.asarray(want.resid), rtol=1e-2,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# Lanczos and SLQ
# ---------------------------------------------------------------------------


def _spd(n, seed=1):
    R = np.random.default_rng(seed).normal(size=(n, n)).astype(np.float32)
    return R @ R.T / n + np.eye(n, dtype=np.float32)


def test_lanczos_matches_jax():
    A = _spd(40)
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (40,)))
    v0 = v0 / np.linalg.norm(v0)
    ja, jb, jV = jax.jit(lambda v: jlanczos_tridiag(lambda u: jnp.asarray(A) @ u, v, 12))(
        jnp.asarray(v0))
    ta, tb, tV = lanczos_tridiag(lambda v: torch.tensor(A) @ v, torch.tensor(v0), 12)
    for got, want in ((ta, ja), (tb, jb), (tV, jV)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **RTOL)
    # top-k from JAX's start vector (the normal draw lanczos_topk makes)
    want = jax.jit(lambda key: jlanczos_topk(lambda v: jnp.asarray(A) @ v, jnp.zeros((40,)),
                                             rng=key, k=5, iters=40))(jax.random.PRNGKey(0))
    got = lanczos_topk(lambda v: torch.tensor(A) @ v, torch.zeros(40), k=5, iters=40,
                       v0=torch.tensor(np.asarray(jax.random.normal(
                           jax.random.PRNGKey(0), (40,)))))
    np.testing.assert_allclose(got.eigvals.numpy(), np.asarray(want.eigvals), rtol=1e-5)
    cos = np.abs(np.sum(got.eigvecs.numpy() * np.asarray(want.eigvecs), axis=1))
    np.testing.assert_allclose(cos, np.ones(5), atol=1e-4)
    # a generator start reaches the same dominant spectrum
    gen = lanczos_topk(lambda v: torch.tensor(A) @ v, torch.zeros(40), k=5, iters=40,
                       rng=torch.Generator().manual_seed(3))
    np.testing.assert_allclose(gen.eigvals.numpy(), np.asarray(want.eigvals), rtol=1e-4)


def _jax_probes(rng, probes, dim):
    """JAX's SLQ probes, made as ``slq_logdet`` makes them."""
    return np.stack([np.asarray(jax.random.rademacher(k, (dim,), jnp.float32))
                     for k in jax.random.split(rng, probes)])


def test_slq_logdet_matches_jax():
    A, B = _spd(6, 2), _spd(8, 3)
    M = np.kron(A, B)
    want = jax.jit(lambda key: jslq_logdet(lambda v: jnp.asarray(M) @ v, jnp.zeros(48),
                                           rng=key, probes=8, iters=20))(jax.random.PRNGKey(1))
    probes = torch.tensor(_jax_probes(jax.random.PRNGKey(1), 8, 48))
    got = slq_logdet(lambda v: torch.tensor(M) @ v, torch.zeros(48), probes=8, iters=20,
                     probe_vectors=probes)
    np.testing.assert_allclose(got.per_probe.numpy(), np.asarray(want.per_probe), **RTOL)
    np.testing.assert_allclose(float(got.logdet), float(want.logdet), rtol=1e-4)
    # generator probes estimate the same log-det (MC tolerance, as JAX's test)
    exact = 8 * np.linalg.slogdet(A)[1] + 6 * np.linalg.slogdet(B)[1]
    est = slq_logdet(lambda v: torch.tensor(M) @ v, torch.zeros(48), probes=64, iters=40,
                     rng=torch.Generator().manual_seed(0))
    assert est.per_probe.shape == (64,)
    np.testing.assert_allclose(float(est.logdet), exact, rtol=0.05)


_EVIDENCE = {}  # JAX's evidence by loss, computed once


@pytest.mark.parametrize("loss,k", [("ce", 1), ("mse", 1), ("ce", 3)])
def test_log_marglik_matfree_matches_jax(loss, k):
    """JAX's probes passed in; the streamed products (k = 3) give the same
    evidence."""
    s = setup("tiny", loss)
    kw = dict(prior_prec=2.0, sigma_noise=0.7, probes=4, iters=12)
    if loss not in _EVIDENCE:
        _EVIDENCE[loss] = jlog_marglik_matfree(s.jmodel, s.jparams, jnp.asarray(s.x),
                                               jnp.asarray(s.y), s.jloss,
                                               rng=jax.random.PRNGKey(7), **kw)
    want = _EVIDENCE[loss]
    probes = torch.tensor(_jax_probes(jax.random.PRNGKey(7), 4, 66))
    x, y = _batch(s)
    cfg = ExtensionConfig(microbatch_size=k) if k > 1 else None
    got = log_marglik_matfree(s.model, s.params, x, y, s.loss, probe_vectors=probes,
                              cfg=cfg, **kw)
    for f in ("log_marglik", "log_lik", "scatter", "log_det_ratio"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-4), f
    np.testing.assert_allclose(got.per_probe.numpy(), want.per_probe, **RTOL)
    assert got.log_det_ratio >= 0


# ---------------------------------------------------------------------------
# the matrix-free natural-gradient step
# ---------------------------------------------------------------------------

NGD = [(solver, k) for solver in ("cg", "kernel") for k in (1, 3)]


@pytest.mark.parametrize("solver,k", NGD, ids=[f"{s}-k{k}" for s, k in NGD])
def test_cg_ngd_step_matches_jax(solver, k):
    """One step of each solver; ``microbatch_size=3`` streams the gradient
    sweep (the accumulated lane, with GGNGram's pair passes) and every
    product.  cg_tol 0 runs the full 8 iterations on both sides (above
    float32's floor, where the recurrences agree: ``test_cg_matches_jax``)."""
    s = setup("tiny")
    mb = k if k > 1 else None
    kw = dict(lr=0.5, damping=0.1, solver=solver, cg_iters=8, cg_tol=0.0, weight_decay=0.01)
    jopt, jstep = jmake_cg_ngd_step(s.jmodel, s.jloss, ext_cfg=JConfig(microbatch_size=mb),
                                    **kw)
    opt, step = make_cg_ngd_step(s.model, s.loss, ext_cfg=ExtensionConfig(microbatch_size=mb),
                                 **kw)
    jp, jst, jm = jax.jit(jstep)(s.jparams, jopt.init(s.jparams),
                                 {"inputs": jnp.asarray(s.x), "labels": jnp.asarray(s.y)}, 0,
                                 jax.random.PRNGKey(0))
    x, y = _batch(s)
    p, st, m = step(s.params, opt.init(s.params), {"inputs": x, "labels": y}, 0)
    # the update, to 1e-4 of its largest entry (the CG solutions' tolerance)
    p0 = _flat(s.params)
    want = _flat(jp) - p0
    np.testing.assert_allclose(_flat(p) - p0, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    assert st["t"] == int(jst["t"]) == 1 and m["step"] == 1
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-6)
    if solver == "cg":
        assert m["cg_iters"] == int(jm["cg_iters"]) == 8
        np.testing.assert_allclose(float(m["cg_resid"]), float(jm["cg_resid"]), rtol=1e-2)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_refusals():
    s = setup("tiny")
    x, y = _batch(s)
    _, v = _tangent(s, 4)
    mesh = object()
    for call in (lambda: ggn_vp(s.model, s.params, x, y, s.loss, v, mesh=mesh),
                 lambda: hvp(s.model, s.params, x, y, s.loss, v, mesh=mesh),
                 lambda: GGNOperator(s.model, s.params, x, y, s.loss, mesh=mesh),
                 lambda: make_cg_ngd_step(s.model, s.loss, lr=0.1, mesh=mesh),
                 lambda: log_marglik_matfree(s.model, s.params, x, y, s.loss, prior_prec=1.0,
                                             mesh=mesh)):
        with pytest.raises(NotImplementedError, match="ROADMAP queue A item 12"):
            call()
    with pytest.raises(ValueError, match="solver must be 'cg' or 'kernel'"):
        make_cg_ngd_step(s.model, s.loss, lr=0.1, solver="lbfgs")
    opt, _ = make_cg_ngd_step(s.model, s.loss, lr=0.1)
    with pytest.raises(NotImplementedError, match="whole-step optimizer"):
        opt.update(None, None, None)
    with pytest.raises(ValueError, match="probe vectors must be"):
        slq_logdet(lambda t: t, torch.zeros(5), probe_vectors=torch.ones(2, 4))
    with pytest.raises(ValueError, match="exceeds operator dim"):
        lanczos_topk(lambda t: t, torch.zeros(3), k=5)
    with pytest.raises(ValueError, match="iters=2 < k=3"):
        lanczos_topk(lambda t: t, torch.zeros(8), k=3, iters=2)
