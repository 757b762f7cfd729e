"""The paper's application in the port, held against the JAX package on the CPU.

Kronecker algebra (``core/kron.py``), the first-order optimizers, the LR
schedules, the curvature-preconditioned optimizer (every backend) and the
train steps get the same numpy-made inputs as their JAX counterparts.  The
JAX steps run jitted, with ``use_kernels=True`` (Pallas interpret mode) on
the route the port takes; the MC draws are JAX's own, made from each step's
logits as ``repro/core/loss_hessian.py`` makes them.

Tolerances: single updates and solves rtol 1e-5 / atol 1e-6 (float32 in
another summation order); three train steps rtol = atol = 1e-4, since each
step's error feeds the next one's curvature and its inverse.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import CASES, _jax_draws

from repro.configs import papernets as jnets
from repro.core import CrossEntropyLoss as JCrossEntropy
from repro.core import ExtensionConfig as JConfig
from repro.core import by_name as jby_name
from repro.core import kron as jkron
from repro.optim import optimizers as joptim
from repro.optim import precond as jprecond
from repro.optim import schedule as jschedule
from repro.train import step as jstep
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import papernets as tnets
from repro_torch.core import CrossEntropyLoss, ExtensionConfig, by_name, kron
from repro_torch.core.engine import AccumulatedSweepPlan, plan_for_batch
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.optim import optimizers, precond, schedule
from repro_torch.train import step as tstep

RTOL, ATOL = 1e-5, 1e-6


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _spd(seed, n):
    m = _rand(seed, n, n + 3)
    return (m @ m.T / n).astype(np.float32)


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.asarray(a)), tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_trees(port, want, rtol=RTOL, atol=ATOL):
    got, ref = tree_leaves(port), jax.tree.leaves(want)
    assert len(got) == len(ref) and ref
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


# -- core/kron.py ----------------------------------------------------------


@pytest.mark.parametrize("diag_a", [False, True], ids=["dense_A", "diag_A"])
def test_kron_matches_jax(diag_a):
    a, b, damping = 6, 4, 0.3
    A = np.abs(_rand(0, a)) + 0.1 if diag_a else _spd(0, a)
    B, g = _spd(1, b), _rand(2, a, b)
    tA, tB, tg = torch.from_numpy(A), torch.from_numpy(B), torch.from_numpy(g)
    jA, jB, jg = jnp.asarray(A), jnp.asarray(B), jnp.asarray(g)
    pairs = [
        (kron.pi_factor(tA, tB), jkron.pi_factor(jA, jB)),
        (kron.damped_inverses(tA, tB, damping), jkron.damped_inverses(jA, jB, damping)),
        (kron.kron_solve(tA, tB, tg, damping), jkron.kron_solve(jA, jB, jg, damping)),
        (kron.kron_solve_bias(tB, tg[0], damping), jkron.kron_solve_bias(jB, jg[0], damping)),
        (kron.kron_mat_vec(tA, tB, tg), jkron.kron_mat_vec(jA, jB, jg)),
        (kron.kron_dense(tA, tB), jkron.kron_dense(jA, jB)),
    ]
    for port, want in pairs:
        _assert_trees(port, want)
    # the solve inverts the damped Kronecker product it approximates
    sol = kron.kron_solve(tA, tB, tg, damping)
    back = kron.kron_mat_vec(tA, tB, sol) + damping * sol
    assert torch.linalg.norm(back - tg) < torch.linalg.norm(tg)


# -- optim/optimizers.py, optim/schedule.py ---------------------------------

PARAMS = ({"w": _rand(3, 5, 4), "b": _rand(4, 4)}, (), {"w": _rand(5, 4, 3)})


@pytest.mark.parametrize("name,kw", [("sgd", dict(lr=0.1)),
                                     ("momentum_sgd", dict(lr=0.1, rho=0.8)),
                                     ("adamw", dict(lr=0.01, weight_decay=0.1))])
def test_first_order_optimizers_match_jax(name, kw):
    opt, jopt = getattr(optimizers, name)(**kw), getattr(joptim, name)(**kw)
    p, jp = _t(PARAMS), _j(PARAMS)
    state, jstate = opt.init(p), jopt.init(jp)
    for i in range(4):
        g = tree_map(lambda a, i=i: _rand(10 + i, *a.shape), PARAMS)
        ups, state = opt.update(_t(g), state, p)
        jups, jstate = jopt.update(_j(g), jstate, jp)
        p, jp = optimizers.apply_updates(p, ups), joptim.apply_updates(jp, jups)
        _assert_trees(p, jp)


def test_schedules_match_jax():
    pairs = [(schedule.constant(), jschedule.constant()),
             (schedule.linear_warmup(5), jschedule.linear_warmup(5)),
             (schedule.cosine(20, warmup_steps=4, final=0.2),
              jschedule.cosine(20, warmup_steps=4, final=0.2)),
             (schedule.cosine(10), jschedule.cosine(10))]
    for f, jf in pairs:
        for step in range(25):
            np.testing.assert_allclose(f(step), float(jf(step)), rtol=1e-6)


def test_mask_buffers_freezes_buffer_and_integer_leaves():
    params = {"w": torch.ones(3), "scale_buf": torch.ones(2),
              "inner": {"mask_buf": torch.ones(2)}, "idx": torch.arange(3)}
    grads = tree_map(lambda p: torch.ones(p.shape), params)
    ups, _ = optimizers.sgd(0.5).update(grads, (), params)
    torch.testing.assert_close(ups["w"], torch.full((3,), -0.5))
    for k in ("scale_buf", "idx"):
        assert not ups[k].any() and ups[k].dtype == params[k].dtype
    assert not ups["inner"]["mask_buf"].any()


# -- optim/precond.py ----------------------------------------------------------


def _curvature(name):
    """A curvature tree of ``name``'s kind for PARAMS (as ``run`` returns it)."""
    if name in precond._DIAG:
        return tree_map(lambda a: np.abs(_rand(20, *a.shape)), PARAMS)
    return ({"w": {"A": _spd(21, 5), "B": _spd(22, 4)}, "b": {"B": _spd(23, 4)}}, (),
            {"w": {"A_diag": np.abs(_rand(24, 4)) + 0.1, "B": _spd(25, 3)}})


@pytest.mark.parametrize("backend", sorted(precond._DIAG | precond._KRON))
def test_curvature_optimizer_matches_jax(backend):
    kw = dict(lr=0.5, damping=0.05, curvature=backend, weight_decay=0.01, stat_decay=0.9)
    opt, jopt = precond.curvature_optimizer(**kw), jprecond.curvature_optimizer(**kw)
    p, jp = _t(PARAMS), _j(PARAMS)
    state, jstate = opt.init(p), jopt.init(jp)
    for i in range(2):  # the second update goes through the EMA of the statistics
        g = tree_map(lambda a, i=i: _rand(30 + i, *a.shape), PARAMS)
        c = tree_map(lambda a, i=i: a * (1 + i), _curvature(backend))
        ups, state = opt.update(_t(g), state, p, curv=_t(c))
        jups, jstate = jopt.update(_j(g), jstate, jp, curv=_j(c))
        _assert_trees(ups, jups)
    assert state["t"] == 2


def test_curvature_optimizer_stacked_kron_factors():
    """A 3-dimensional B is a stack of layers, solved one by one (the batched
    solve JAX vmaps)."""
    L = 3
    params = {"w": _rand(40, L, 5, 4), "b": _rand(41, L, 4)}
    curv = {"w": {"A": np.stack([_spd(42 + i, 5) for i in range(L)]),
                  "B": np.stack([_spd(45 + i, 4) for i in range(L)])},
            "b": {"B": np.stack([_spd(48 + i, 4) for i in range(L)])}}
    grads = tree_map(lambda a: _rand(51, *a.shape), params)
    kw = dict(lr=1.0, damping=0.1, curvature="kfac")
    ups, _ = precond.curvature_optimizer(**kw).update(
        _t(grads), precond.curvature_optimizer(**kw).init(None), _t(params), curv=_t(curv))
    jups, _ = jprecond.curvature_optimizer(**kw).update(
        _j(grads), jprecond.curvature_optimizer(**kw).init(None), _j(params), curv=_j(curv))
    _assert_trees(ups, jups)


def test_curvature_optimizer_rejects_unknown_backend_and_missing_curv():
    with pytest.raises(ValueError, match="curvature must be one of"):
        precond.curvature_optimizer(0.1, curvature="hessian")
    opt = precond.curvature_optimizer(0.1)
    with pytest.raises(ValueError, match="needs curv="):
        opt.update(_t(PARAMS), opt.init(None), _t(PARAMS))


# -- core/engine.plan_for_batch ------------------------------------------------


def test_plan_for_batch_single_lane_only():
    """One slice is the single-device plan, several the accumulated lane;
    a mesh (the sharded lane, item 12) still raises."""
    exts = (by_name("kfac"),)
    assert plan_for_batch(exts, None, 8).names == {"kfac"}
    assert plan_for_batch(exts, None, 8, microbatch_size=8).names == {"kfac"}
    with pytest.raises(NotImplementedError, match="item 12"):
        plan_for_batch(exts, None, 8, mesh=object())
    plan = plan_for_batch(exts, None, 8, microbatch_size=3)
    assert isinstance(plan, AccumulatedSweepPlan)
    assert plan.num_microbatches == 3 and plan.plan.names == {"kfac"}


# -- train/step.py ---------------------------------------------------------------

STEP_CASES = {"mlp": (dict(lr=0.5, damping=0.1, curvature="kfac"), ("kfac", "variance")),
              "c2d2": (dict(lr=0.1, damping=1.0, curvature="diag_ggn_mc"),
                       ("diag_ggn_mc", "batch_l2"))}
MC = 1


def _setup(name):
    case = CASES[name]
    jmodel = getattr(jnets, case.net)(**dict(case.kwargs))
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(7)
    x = rs.randn(*case.input_shape).astype(np.float32)
    y = rs.randint(0, case.n_classes, case.input_shape[0])
    model = getattr(tnets, case.net)(**dict(case.kwargs), device="cpu")
    return case, jmodel, np_params, model, x, y


@pytest.mark.parametrize("use_fused", [True, False], ids=["fused", "per_extension"])
@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_extended_train_step_matches_jax(name, use_fused):
    kw, ext_names = STEP_CASES[name]
    case, jmodel, np_params, model, x, y = _setup(name)
    jexts = tuple(jby_name(n) for n in ext_names)
    jstep_fn = jax.jit(jstep.make_extended_train_step(
        jmodel, JCrossEntropy(), jprecond.curvature_optimizer(**kw), jexts,
        JConfig(use_kernels=True, use_fused=use_fused, mc_samples=MC), track=("variance",)))
    step_fn = tstep.make_extended_train_step(
        model, CrossEntropyLoss(), precond.curvature_optimizer(**kw),
        tuple(by_name(n) for n in ext_names),
        ExtensionConfig(use_kernels=True, use_fused=use_fused, mc_samples=MC),
        track=("variance",))
    jp, p = _j(np_params), params_from_numpy(model, np_params, "cpu")
    jstate = jprecond.curvature_optimizer(**kw).init(jp)
    state = precond.curvature_optimizer(**kw).init(p)
    batch = {"inputs": torch.from_numpy(x), "labels": torch.from_numpy(y)}
    jbatch = {"inputs": jnp.asarray(x), "labels": jnp.asarray(y)}
    base = jax.random.PRNGKey(5)
    for i in range(3):
        rng = jax.random.fold_in(base, i)
        draws = _jax_draws(case, jmodel.apply(jp, jbatch["inputs"]), rng, MC)
        jp, jstate, jm = jstep_fn(jp, jstate, jbatch, jnp.int32(i), rng)
        p, state, m = step_fn(p, state, batch, i, torch.tensor(draws))
        np.testing.assert_allclose(m["loss"].numpy(), jm["loss"], rtol=1e-4)
        assert m["step"] == int(jm["step"]) == i + 1
        assert ("variance_mean" in m) == ("variance_mean" in jm)
        if "variance_mean" in m:
            np.testing.assert_allclose(m["variance_mean"].numpy(), jm["variance_mean"],
                                       rtol=1e-4)
        _assert_trees(p, jp, rtol=1e-4, atol=1e-4)



@pytest.mark.parametrize("use_fused", [True, False], ids=["fused", "per_extension"])
@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_extended_train_step_microbatch_matches_jax(name, use_fused):
    """``ExtensionConfig(microbatch_size=3)``: the step's sweep on the
    accumulated lane, against JAX's step on its accumulated lane (the MC
    draws JAX's, made for the whole batch; JAX keys them by sample index, so
    its slices draw what its monolithic sweep draws) and against the port's
    monolithic step."""
    kw, ext_names = STEP_CASES[name]
    case, jmodel, np_params, model, x, y = _setup(name)
    jexts = tuple(jby_name(n) for n in ext_names)
    exts = tuple(by_name(n) for n in ext_names)
    jstep_fn = jax.jit(jstep.make_extended_train_step(
        jmodel, JCrossEntropy(), jprecond.curvature_optimizer(**kw), jexts,
        JConfig(use_kernels=True, use_fused=use_fused, mc_samples=MC, microbatch_size=3),
        track=("variance",)))
    steps = {mb: tstep.make_extended_train_step(
        model, CrossEntropyLoss(), precond.curvature_optimizer(**kw), exts,
        ExtensionConfig(use_kernels=True, use_fused=use_fused, mc_samples=MC,
                        microbatch_size=mb), track=("variance",)) for mb in (None, 3)}
    jp, p = _j(np_params), params_from_numpy(model, np_params, "cpu")
    batch = {"inputs": torch.from_numpy(x), "labels": torch.from_numpy(y)}
    jbatch = {"inputs": jnp.asarray(x), "labels": jnp.asarray(y)}
    rng = jax.random.PRNGKey(5)
    draws = torch.tensor(_jax_draws(case, jmodel.apply(jp, jbatch["inputs"]), rng, MC))
    jp1, _, jm = jstep_fn(jp, jprecond.curvature_optimizer(**kw).init(jp), jbatch,
                          jnp.int32(0), rng)
    out = {mb: f(p, precond.curvature_optimizer(**kw).init(p), batch, 0, draws)
           for mb, f in steps.items()}
    p1, _, m = out[3]
    np.testing.assert_allclose(m["loss"].numpy(), jm["loss"], rtol=1e-5)
    if "variance_mean" in m:
        np.testing.assert_allclose(m["variance_mean"].numpy(), jm["variance_mean"], rtol=1e-4)
    _assert_trees(p1, jp1, rtol=2e-5, atol=2e-6)
    _assert_trees(p1, tree_map(lambda t: t.numpy(), out[None][0]), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_step_matches_jax(microbatch, remat):
    case, jmodel, np_params, model, x, y = _setup("c2d2")
    # momentum SGD: Adam's g/√v would turn the rounding of near-zero
    # gradients (dead ReLU units) into ±lr steps (its own test is above).
    kw = dict(lr=0.1, rho=0.9)
    jstep_fn = jax.jit(jstep.make_train_step(jmodel, JCrossEntropy(), joptim.momentum_sgd(**kw),
                                             microbatch=microbatch, remat=remat))
    step_fn = tstep.make_train_step(model, CrossEntropyLoss(), optimizers.momentum_sgd(**kw),
                                    microbatch=microbatch, remat=remat)
    jp, p = _j(np_params), params_from_numpy(model, np_params, "cpu")
    jstate = joptim.momentum_sgd(**kw).init(jp)
    state = optimizers.momentum_sgd(**kw).init(p)
    x, y = np.concatenate([x, x[:1]]), np.concatenate([y, y[:1]])  # an even batch
    batch = {"inputs": torch.from_numpy(x), "labels": torch.from_numpy(y)}
    jbatch = {"inputs": jnp.asarray(x), "labels": jnp.asarray(y)}
    for i in range(3):
        jp, jstate, jm = jstep_fn(jp, jstate, jbatch, jnp.int32(i))
        p, state, m = step_fn(p, state, batch, i)
        np.testing.assert_allclose(m["loss"].numpy(), jm["loss"], rtol=1e-5)
        _assert_trees(p, jp, rtol=1e-4, atol=1e-5)
    assert not any(leaf.requires_grad for leaf in tree_leaves(p))


def test_train_step_rejects_uneven_microbatches():
    _, _, np_params, model, x, y = _setup("mlp")
    step_fn = tstep.make_train_step(model, CrossEntropyLoss(), optimizers.sgd(0.1),
                                    microbatch=4)
    batch = {"inputs": torch.from_numpy(x), "labels": torch.from_numpy(y)}
    with pytest.raises(ValueError, match="does not split"):
        step_fn(params_from_numpy(model, np_params, "cpu"), (), batch, 0)


def test_kfac_training_halves_the_loss():
    """Port of ``tests/test_papernets.py::test_logreg_and_mlp_train``: 20
    KFAC-preconditioned steps on a separable 4-class problem."""
    model = tnets.mlp(n_classes=4, in_dim=10, hidden=(16,), device="cpu",
                      generator=torch.Generator().manual_seed(0))
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(32, 10).astype(np.float32))
    y = (x[:, 0] > 0).long() + 2 * (x[:, 1] > 0).long()
    opt = precond.curvature_optimizer(1.0, damping=1e-1, curvature="kfac")
    step_fn = tstep.make_extended_train_step(model, CrossEntropyLoss(), opt,
                                             (by_name("kfac"),))
    params, state = model.params(), opt.init(None)
    gen = torch.Generator().manual_seed(1)
    losses = []
    for i in range(20):
        params, state, m = step_fn(params, state, {"inputs": x, "labels": y}, i, gen)
        losses.append(m["loss"].item())
    assert losses[-1] < 0.5 * losses[0], losses
