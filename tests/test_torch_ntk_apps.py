"""The port's NTK consumers held against the JAX package's on the CPU.

* ``ntk_kernel`` and ``per_sample_grads``, monolithic and in slices;
* ``kernel_solve`` with each solver ('cholesky', 'eigh' full and truncated,
  'lanczos' with JAX's start vector), and ``gp_predict`` on logreg and mlp
  (6→8→3) with each solver, monolithic and streamed at k ∈ {2, 3};
* ``influence_scores`` / ``self_influence`` with the CG iteration count
  fixed, monolithic and streamed;
* ``greedy_max_diversity`` / ``bait_select`` on JAX's kernels and
  ``select_subset`` (NTK and GGNGram, monolithic and streamed): the same
  indices;
* the refusals: bad ``k``, an unknown solver or method, ``'lanczos'``
  without ``rank``, ``mesh=`` (ROADMAP queue A item 12), and the launcher's
  ``--shard-sweep`` (item 12); the launcher's ``--trace-jsonl`` writes the
  run's ``ntk_apps/*`` spans.

Nothing is held against JAX's sharded GP test.  Parameters are initialised
in JAX and cross by numpy.  Tolerances: kernels, GP mean and variance and
solves ``_oracles.TOL`` (rtol = atol = 3e-5; ridge 2.0 keeps cond(K + λI)
≲ 60, as JAX's own test); the Lanczos-preconditioned solve rtol 1e-4 (a
float32 CG recurrence); influence scores and selection objectives rtol 1e-4
with an atol of 1e-4 of their largest entry (8 CG iterations, or a greedy
chain of float32 solves).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _oracles import TOL, tiny_mlp
from repro.configs import papernets as jnets
from repro.core import CrossEntropyLoss as JCrossEntropy
from repro.ntk_apps import gp_predict as jgp_predict
from repro.ntk_apps import influence_scores as jinfluence_scores
from repro.ntk_apps import kernel_solve as jkernel_solve
from repro.ntk_apps import ntk_kernel as jntk_kernel
from repro.ntk_apps import select_subset as jselect_subset
from repro.ntk_apps import self_influence as jself_influence
from repro.ntk_apps.influence import per_sample_grads as jper_sample_grads
from repro_torch import obs
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import papernets as tnets
from repro_torch.core import Activation, CrossEntropyLoss, Dense, Sequential
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import ntk_apps as launcher
from repro_torch.ntk_apps import (
    bait_select,
    gp_predict,
    greedy_max_diversity,
    influence_scores,
    kernel_solve,
    ntk_kernel,
    select_subset,
    self_influence,
)
from repro_torch.ntk_apps.influence import per_sample_grads
from repro_torch.obs.reporting import load_jsonl

JLOSS, LOSS = JCrossEntropy(), CrossEntropyLoss()
RIDGE = 2.0  # cond(K + λI) ≲ 60 (JAX's test_gp_predictive_matches_dense_oracle_on_papernets)


def _scaled(got, want, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


_NETS = {}


def net(name):
    """JAX and port model and params, train and test batches (made once):
    ``tiny`` is ``_oracles.tiny_mlp`` (11 rows, 4 test rows), ``logreg`` and
    ``mlp`` the 6→3 / 6→8→3 papernets of JAX's test (12 + 4 rows)."""
    if name in _NETS:
        return _NETS[name]
    if name == "tiny":
        jmodel, jparams, x, y = tiny_mlp()
        model = Sequential([Dense(5, 7, device="cpu"), Activation("tanh"),
                            Dense(7, 3, device="cpu")])
        x_te = jax.random.normal(jax.random.PRNGKey(7), (4, 5))
        y_te = jax.random.randint(jax.random.PRNGKey(8), (4,), 0, 3)
    else:
        if name == "logreg":
            jmodel = jnets.logreg(n_classes=3, in_dim=6)
            model = tnets.logreg(n_classes=3, in_dim=6, device="cpu")
        else:
            jmodel = jnets.mlp(n_classes=3, in_dim=6, hidden=(8,))
            model = tnets.mlp(n_classes=3, in_dim=6, hidden=(8,), device="cpu")
        jparams = jmodel.init(jax.random.PRNGKey(0))
        x = jax.random.normal(jax.random.PRNGKey(1), (12, 6))
        y = jax.random.randint(jax.random.PRNGKey(2), (12,), 0, 3)
        x_te = jax.random.normal(jax.random.PRNGKey(3), (4, 6))
        y_te = jax.random.randint(jax.random.PRNGKey(4), (4,), 0, 3)
    params = params_from_numpy(model, jax.tree.map(np.asarray, jparams), "cpu")
    t = {k: torch.tensor(np.asarray(v)) for k, v in
         dict(x=x, y=y, x_te=x_te, y_te=y_te).items()}
    t["y"], t["y_te"] = t["y"].long(), t["y_te"].long()
    _NETS[name] = dict(jmodel=jmodel, jparams=jparams, model=model, params=params, x=x, y=y,
                       x_te=x_te, y_te=y_te, t=t)
    return _NETS[name]


# ---------------------------------------------------------------------------
# kernels and per-sample gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 3])
def test_ntk_kernel_and_per_sample_grads_match_jax(k):
    s = net("tiny")
    mb = k if k > 1 else None
    want = jntk_kernel(s["jmodel"], s["jparams"], s["x"], s["y"], JLOSS)
    got = ntk_kernel(s["model"], s["params"], s["t"]["x"], s["t"]["y"], LOSS, microbatches=mb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jper_sample_grads(s["jmodel"], s["jparams"], s["x"], s["y"], JLOSS)
    got = per_sample_grads(s["model"], s["params"], s["t"]["x"], s["t"]["y"], LOSS,
                           microbatches=mb)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# ---------------------------------------------------------------------------
# Gram-space solves and the GP predictive
# ---------------------------------------------------------------------------

SOLVES = {"cholesky": {}, "eigh": dict(solver="eigh"), "eigh-rank4": dict(solver="eigh", rank=4),
          "lanczos": dict(solver="lanczos", rank=4, cg_tol=1e-6)}


@pytest.mark.parametrize("case", SOLVES)
def test_kernel_solve_matches_jax(case):
    rs = np.random.default_rng(0)
    R = rs.normal(size=(10, 10)).astype(np.float32)
    K = R @ R.T / 10
    B = rs.normal(size=(10, 2)).astype(np.float32)
    kw = dict(SOLVES[case], ridge=0.5)
    v0 = torch.tensor(np.asarray(jax.random.normal(jax.random.PRNGKey(0), (10,))))
    for b in (B, B[:, 0]):  # [n, C] and [n]
        X, info = kernel_solve(torch.tensor(K), torch.tensor(b), rng=v0, **kw)
        jX, jinfo = jkernel_solve(jnp.asarray(K), jnp.asarray(b), **kw)
        tol = RTOL_LANCZOS if case == "lanczos" else TOL
        np.testing.assert_allclose(X.numpy(), np.asarray(jX), **tol)
        assert info.method == jinfo.method and info.rank == jinfo.rank
        assert info.iters == int(jinfo.iters)
        if case == "eigh-rank4":  # truncated: the tail is solved at ridge only
            assert float(info.resid) == pytest.approx(float(jinfo.resid), rel=1e-4)
        else:
            assert float(info.resid) <= (1e-6 if case == "lanczos" else 1e-5)


RTOL_LANCZOS = dict(rtol=1e-4, atol=1e-5)
_GP = {}  # JAX's monolithic GP by (net, solver), computed once
GP = [("logreg", "cholesky", 1), ("mlp", "cholesky", 1), ("mlp", "eigh", 1),
      ("mlp", "lanczos", 1), ("mlp", "cholesky", 2), ("mlp", "cholesky", 3),
      ("mlp", "lanczos", 3)]


@pytest.mark.parametrize("name,solver,k", GP, ids=[f"{n}-{s}-k{k}" for n, s, k in GP])
def test_gp_predict_matches_jax(name, solver, k):
    """The port (its NTK in ``k`` row blocks when k > 1) against JAX's
    monolithic GP; the Lanczos solver starts from JAX's normal draw."""
    s = net(name)
    kw = dict(ridge=RIDGE, solver=solver)
    if solver == "lanczos":
        kw.update(rank=8, cg_tol=1e-6)
    if (name, solver) not in _GP:
        _GP[name, solver] = jgp_predict(s["jmodel"], s["jparams"], s["x"], s["y"], s["x_te"],
                                        JLOSS, **kw)
    want = _GP[name, solver]
    v0 = torch.tensor(np.asarray(jax.random.normal(jax.random.PRNGKey(0), (12,))))
    t = s["t"]
    got = gp_predict(s["model"], s["params"], t["x"], t["y"], t["x_te"], LOSS,
                     microbatches=k if k > 1 else None, rng=v0, **kw)
    tol = RTOL_LANCZOS if solver == "lanczos" else TOL
    np.testing.assert_allclose(got.kernel.numpy(), np.asarray(want.kernel), **TOL)
    for f in ("mean", "var", "alpha"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   **tol, err_msg=f)
    assert got.info.method == solver and float(got.var.min()) > 0
    if solver == "lanczos":
        assert got.info.iters > 0 and float(got.info.resid) <= 1e-6


# ---------------------------------------------------------------------------
# influence
# ---------------------------------------------------------------------------


_INFLUENCE = {}


def jax_influence():
    """JAX's monolithic influence and self-influence on ``tiny`` (once),
    8 CG iterations (tol 0)."""
    if not _INFLUENCE:
        s = net("tiny")
        kw = dict(damping=0.1, cg_tol=0.0, cg_maxiter=8)
        _INFLUENCE["scores"] = jax.jit(lambda p: jinfluence_scores(
            s["jmodel"], p, s["x"], s["y"], s["x_te"], s["y_te"], JLOSS, **kw))(s["jparams"])
        _INFLUENCE["self"] = jax.jit(lambda p: jself_influence(
            s["jmodel"], p, s["x"], s["y"], JLOSS, **kw))(s["jparams"])
    return _INFLUENCE


@pytest.mark.parametrize("k", [1, 2, 3])
def test_influence_matches_jax(k):
    """The port, monolithic or streamed (products and per-sample gradients in
    k slices), against JAX's monolithic scores.  8 CG iterations on both
    sides: above float32's floor, where the recurrences agree
    (``test_torch_matfree.test_cg_matches_jax``)."""
    s = net("tiny")
    t = s["t"]
    kw = dict(damping=0.1, cg_tol=0.0, cg_maxiter=8, microbatches=k if k > 1 else None)
    want = jax_influence()
    got = influence_scores(s["model"], s["params"], t["x"], t["y"], t["x_te"], t["y_te"], LOSS,
                           **kw)
    got_self = self_influence(s["model"], s["params"], t["x"], t["y"], LOSS, **kw)
    for g, w in ((got, want["scores"]), (got_self, want["self"])):
        assert g.iters == int(w.iters) == 8
        assert tuple(g.scores.shape) == w.scores.shape
        _scaled(g.scores.numpy(), w.scores)
        np.testing.assert_allclose(g.resid.numpy(), np.asarray(w.resid), rtol=1e-2)


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------

_SELECT = {}


def jax_select(method):
    """JAX's ``select_subset`` of 3 points of ``tiny`` (once a method)."""
    if method not in _SELECT:
        s = net("tiny")
        _SELECT[method] = jselect_subset(s["jmodel"], s["jparams"], s["x"], s["y"], JLOSS, 3,
                                         method=method, lam=0.5)
    return _SELECT[method]


@pytest.mark.parametrize("method", ["diversity", "bait"])
def test_selector_matches_jax_on_its_kernel(method):
    want = jax_select(method)
    K = torch.tensor(np.asarray(want.kernel))
    idx, scores = (greedy_max_diversity(K, 3) if method == "diversity"
                   else bait_select(K, 3, lam=0.5))
    assert idx.tolist() == np.asarray(want.indices).tolist()
    _scaled(scores.numpy(), want.scores)


SELECT = [(m, k) for m in ("diversity", "bait") for k in (1, 3)]


@pytest.mark.parametrize("method,k", SELECT, ids=[f"{m}-k{k}" for m, k in SELECT])
def test_select_subset_matches_jax(method, k):
    """The port's extraction (in k row blocks when k > 1) and selection
    against JAX's monolithic one: the same indices."""
    s = net("tiny")
    t = s["t"]
    want = jax_select(method)
    got = select_subset(s["model"], s["params"], t["x"], t["y"], LOSS, 3, method=method,
                        lam=0.5, microbatches=k if k > 1 else None)
    np.testing.assert_allclose(got.kernel.numpy(), np.asarray(want.kernel), **TOL)
    assert got.indices.tolist() == np.asarray(want.indices).tolist()
    _scaled(got.scores.numpy(), want.scores)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_refusals():
    K, b = torch.eye(4), torch.ones(4)
    with pytest.raises(ValueError, match="unknown solver"):
        kernel_solve(K, b, ridge=1e-2, solver="qr")
    with pytest.raises(ValueError, match="needs rank"):
        kernel_solve(K, b, ridge=1e-2, solver="lanczos")
    with pytest.raises(ValueError, match="outside"):
        greedy_max_diversity(torch.eye(5), 6)
    with pytest.raises(ValueError, match="outside"):
        bait_select(torch.eye(5), 0)
    s = net("tiny")
    m, p, t = s["model"], s["params"], s["t"]
    with pytest.raises(ValueError, match="unknown method"):
        select_subset(m, p, t["x"], t["y"], LOSS, 2, method="random")
    mesh = object()
    for call in (lambda: ntk_kernel(m, p, t["x"], t["y"], LOSS, mesh=mesh),
                 lambda: gp_predict(m, p, t["x"], t["y"], t["x_te"], LOSS, mesh=mesh),
                 lambda: influence_scores(m, p, t["x"], t["y"], t["x_te"], t["y_te"], LOSS,
                                          mesh=mesh),
                 lambda: self_influence(m, p, t["x"], t["y"], LOSS, mesh=mesh),
                 lambda: select_subset(m, p, t["x"], t["y"], LOSS, 2, mesh=mesh)):
        with pytest.raises(NotImplementedError, match="ROADMAP queue A item 12"):
            call()
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item 12"):
        launcher.main(["--gp", "--device", "cpu", "--shard-sweep"])


def test_launcher_trace_jsonl_writes_the_ntk_apps_spans(tmp_path, capsys):
    trace = str(tmp_path / "t.jsonl")
    launcher.main(["--gp", "--device", "cpu", "--n-train", "16", "--n-test", "4",
                   "--trace-jsonl", trace])
    assert not obs.enabled()
    spans = [(tuple(e["path"]), e["attrs"]) for e in load_jsonl(trace) if e["kind"] == "span"]
    gp = ("ntk_apps/gp_predict",)
    assert [p for p, _ in spans] == [
        gp + ("ntk_apps/kernel", "engine/sweep"), gp + ("ntk_apps/kernel",),
        gp + ("ntk_apps/kernel_solve",), gp + ("ntk_apps/kernel_solve",), gp]
    assert spans[-1][1] == {"n_train": 16, "n_test": 4, "solver": "cholesky"}
    assert f"[obs] trace written to {trace}" in capsys.readouterr().out
