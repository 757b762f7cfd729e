"""The port's checkpointed accumulated sweep: interrupt, resume, and the
checkpoint layer underneath, on the CPU.

The single-device cases of ``tests/test_resume.py``.  A sweep killed by
``FailureInjector`` at any work unit and resumed from its
``SweepCheckpointer`` snapshot gives the uninterrupted run's results bit for
bit (the same operations in the same order on the CPU), MC draws from
``mc_seed`` and the Variance reducer's Chan (n, mean, M2) triples included;
the extensions without MC draws also match JAX's accumulated run (rtol =
atol = 3e-5, the differential tolerance).  The checkpoint layer: stale
``.tmp_save_*`` sweeping, ``keep < 1`` refused, the tree structure and each
leaf's shape checked on restore, the snapshot store's round trip.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Activation as JActivation
from repro.core import CrossEntropyLoss as JCrossEntropy
from repro.core import Dense as JDense
from repro.core import ExtensionConfig as JConfig
from repro.core import Sequential as JSequential
from repro.core import by_name as jby_name
from repro.core import plan_sweeps as jplan_sweeps
from repro_torch import laplace as tl
from repro_torch.bridge import params_from_numpy
from repro_torch.core import (
    Activation,
    CrossEntropyLoss,
    Dense,
    Extension,
    ExtensionConfig,
    Reducer,
    Sequential,
    SweepStream,
    by_name,
    plan_sweeps,
)
from repro_torch.core.tree import tree_leaves
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.checkpoint import SweepCheckpointer
from repro_torch.train.fault import FailureInjector, SimulatedFailure, run_sweep_with_restarts

N, D_IN, H, C = 10, 6, 7, 4
TOL = dict(rtol=3e-5, atol=3e-5)
# One extension for each accumulator: rows (batch_grad, batch_l2), the Chan
# triple (variance), MC draws (diag_ggn_mc, kfac), kron, KFRA's partial
# means and replay, and both pairwise streams (batch_dot, ntk).
EXTS = ("batch_grad", "batch_l2", "variance", "diag_ggn_mc", "kfac", "kfra", "batch_dot", "ntk")
NO_MC = tuple(n for n in EXTS if n not in ("diag_ggn_mc", "kfac"))
# N = 10, k = 3: slices of 4, 4 and 2, then the pairs (0, 1), (0, 2), (1, 2).
UNITS = 6


def _setup():
    jmodel = JSequential([JDense(D_IN, H), JActivation("sigmoid"), JDense(H, C)])
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    model = Sequential([Dense(D_IN, H, device="cpu"), Activation("sigmoid"),
                        Dense(H, C, device="cpu")])
    rs = np.random.RandomState(1)
    x = rs.randn(N, D_IN).astype(np.float32)
    y = rs.randint(0, C, N)
    return dict(jmodel=jmodel, np_params=np_params, model=model,
                params=params_from_numpy(model, np_params, "cpu"),
                x=torch.from_numpy(x), y=torch.from_numpy(y), jx=jnp.asarray(x),
                jy=jnp.asarray(y))


@pytest.fixture(scope="module")
def setup():
    return _setup()


def _plan(k=3, seed=7):
    cfg = ExtensionConfig(mc_seed=seed)
    return plan_sweeps(tuple(by_name(n) for n in EXTS), cfg).accumulate(k), cfg


def _args(s):
    return s["model"], s["params"], s["x"], s["y"], CrossEntropyLoss()


def _assert_identical(ref, res, names=EXTS):
    assert torch.equal(ref.loss, res.loss)
    for part in ("grads", "logits"):
        for u, v in zip(tree_leaves(getattr(ref, part)), tree_leaves(getattr(res, part)),
                        strict=True):
            assert torch.equal(u, v), part
    for nm in names:
        for u, v in zip(tree_leaves(ref.ext[nm]), tree_leaves(res.ext[nm]), strict=True):
            assert torch.equal(u, v), nm


_JAX = {}


def _jax_accumulated(s):
    """JAX's accumulate(3) of the extensions without MC draws (once)."""
    if not _JAX:
        plan = jplan_sweeps(tuple(jby_name(n) for n in NO_MC), JConfig()).accumulate(3)
        r = plan.run(s["jmodel"], jax.tree.map(jnp.asarray, s["np_params"]), s["jx"], s["jy"],
                     JCrossEntropy(), cfg=JConfig())
        _JAX["res"] = r
    return _JAX["res"]


def test_stream_matches_jax_and_run(setup):
    """``run_checkpointed`` without a checkpointer is ``run``: the same
    stream; its non-MC results match JAX's accumulated lane."""
    plan, cfg = _plan()
    ref = plan.run(*_args(setup), cfg=cfg)
    res = plan.run_checkpointed(*_args(setup), cfg=cfg)
    _assert_identical(ref, res)
    jres = _jax_accumulated(setup)
    np.testing.assert_allclose(res.loss.numpy(), np.asarray(jres.loss), rtol=1e-6)
    for part in ("grads", "logits"):
        for u, v in zip(tree_leaves(getattr(res, part)), jax.tree.leaves(getattr(jres, part)),
                        strict=True):
            np.testing.assert_allclose(u.numpy(), np.asarray(v), rtol=1e-5, atol=1e-6)
    for nm in NO_MC:
        for u, v in zip(tree_leaves(res.ext[nm]), jax.tree.leaves(jres.ext[nm]), strict=True):
            np.testing.assert_allclose(u.numpy(), np.asarray(v), err_msg=nm, **TOL)


def test_stream_state_is_arrays_only(setup):
    plan, cfg = _plan()
    stream = plan.stream(*_args(setup), cfg=cfg)
    assert stream.num_units == UNITS
    stream.step()
    for leaf in tree_leaves(stream.state_arrays()):
        assert isinstance(leaf, torch.Tensor), leaf
    meta = stream.schedule_meta()
    json.dumps(meta)  # manifest-safe
    assert meta["n"] == N and meta["work_units"] == stream.num_units
    assert meta["rng"] == "mc_seed=7" and meta["draws"]


def test_variance_chan_triple_rides_the_snapshot(setup):
    """Variance snapshots as raw mergeable Chan triples (n / mean / M2),
    counting the slices' rows folded so far."""
    plan, cfg = _plan()
    stream = plan.stream(*_args(setup), cfg=cfg)
    found = []

    def triples(node):
        if isinstance(node, dict) and set(node) == {"n", "mean", "m2"}:
            found.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                triples(v)
        elif isinstance(node, (tuple, list)):
            for v in node:
                triples(v)

    for rows in (stream.m, 2 * stream.m):
        stream.step()
        found.clear()
        triples(stream.state_arrays()["carry"]["variance"])
        assert found and all(float(t["n"]) == rows for t in found)


@pytest.mark.parametrize("fail_at", range(1, UNITS))
def test_interrupt_resume_exact(setup, tmp_path, fail_at):
    """Kill the stream before work unit ``fail_at`` (slices and pair passes
    both), resume from disk: the uninterrupted run's results bit for bit."""
    plan, cfg = _plan()
    ref = plan.run(*_args(setup), cfg=cfg)
    store = SweepCheckpointer(str(tmp_path / "sweep"))
    with pytest.raises(SimulatedFailure):
        plan.run_checkpointed(*_args(setup), cfg=cfg, checkpointer=store,
                              injector=FailureInjector(fail_at_step=fail_at))
    assert store.latest() == fail_at  # a snapshot after every unit
    res = plan.resume(*_args(setup), store, cfg=cfg)
    _assert_identical(ref, res)


def test_run_sweep_with_restarts(setup, tmp_path):
    plan, cfg = _plan()
    ref = plan.run(*_args(setup), cfg=cfg)
    res, restarts = run_sweep_with_restarts(
        plan, *_args(setup), SweepCheckpointer(str(tmp_path / "sweep")), cfg=cfg,
        injector=FailureInjector(fail_at_step=2))
    assert restarts == 1
    _assert_identical(ref, res)


def test_resume_validates_schedule_meta(setup, tmp_path):
    """A rebuilt stream with another seed, schedule or draws is refused,
    naming the first field that differs."""
    plan, cfg = _plan()
    store = SweepCheckpointer(str(tmp_path / "sweep"))
    with pytest.raises(SimulatedFailure):
        plan.run_checkpointed(*_args(setup), cfg=cfg, checkpointer=store,
                              injector=FailureInjector(fail_at_step=2))
    with pytest.raises(ValueError, match="'rng'"):
        plan.resume(*_args(setup), store, cfg=ExtensionConfig(mc_seed=8))
    with pytest.raises(ValueError, match="'num_microbatches'"):
        _plan(k=4)[0].resume(*_args(setup), store, cfg=cfg)
    draws = torch.randint(0, C, (1, N), generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="'rng'"):
        plan.resume(*_args(setup), store, cfg=ExtensionConfig(), rng=draws)


def test_checkpointed_mc_needs_replayable_draws(setup, tmp_path):
    """A caller's generator cannot be replayed on resume: a checkpointed MC
    sweep takes ``mc_seed`` or draws."""
    plan, _ = _plan()
    gen = torch.Generator().manual_seed(7)
    store = SweepCheckpointer(str(tmp_path / "sweep"))
    with pytest.raises(ValueError, match="mc_seed"):
        plan.run_checkpointed(*_args(setup), cfg=ExtensionConfig(), rng=gen,
                              checkpointer=store)
    with pytest.raises(ValueError, match="mc_seed"):
        plan.resume(*_args(setup), store, cfg=ExtensionConfig(), rng=gen)
    plan.run_checkpointed(*_args(setup), cfg=ExtensionConfig(), rng=gen)  # no snapshots


def test_strict_resume_requires_snapshot(setup, tmp_path):
    plan, cfg = _plan()
    with pytest.raises(FileNotFoundError, match="no sweep snapshot"):
        plan.resume(*_args(setup), SweepCheckpointer(str(tmp_path / "empty")), cfg=cfg)


def test_supports_checkpoint_gate(setup):
    """A reducer whose accumulator cannot round-trip is refused by the
    checkpointable stream, naming extension and reducer; the uncheckpointed
    stream ``run`` drives does not check it."""

    class OpaqueReducer(Reducer):
        name = "opaque_test"
        supports_checkpoint = False

    ext = Extension("_opaque_stat", "first", reduce=OpaqueReducer())
    plan = plan_sweeps((ext,), ExtensionConfig()).accumulate(2)
    with pytest.raises(ValueError, match="supports_checkpoint") as ei:
        plan.stream(*_args(setup))
    assert "_opaque_stat" in str(ei.value) and "opaque_test" in str(ei.value)
    assert SweepStream(plan, *_args(setup)).num_units == 2


def test_laplace_resumable_fit(setup, tmp_path):
    """A killed streaming Laplace fit resumes to the uninterrupted posterior;
    a checkpointed fit without slices is refused."""
    args = _args(setup)
    cfg = ExtensionConfig(mc_seed=5)
    opts = tl.FitOptions(mc=True, cfg=cfg, microbatch_size=4)
    ref = tl.fit_posterior(*args, structure="diag", options=opts)
    d = str(tmp_path / "fit")
    with pytest.raises(SimulatedFailure):
        tl.fit_posterior(*args, structure="diag",
                         options=opts.replace(ckpt_dir=d, injector=FailureInjector(fail_at_step=1)))
    post = tl.fit_posterior(*args, structure="diag", options=opts.replace(ckpt_dir=d, resume=True))
    for u, v in zip(tree_leaves(ref.curv), tree_leaves(post.curv), strict=True):
        assert torch.equal(u, v)
    with pytest.raises(tl.LaplaceStructureError, match="streaming accumulated sweep"):
        tl.fit_posterior(*args, structure="diag",
                         options=tl.FitOptions(mc=True, cfg=cfg, ckpt_dir=d))


# -- the checkpoint layer ------------------------------------------------------


def test_gc_sweeps_stale_tmp_dirs(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, ".tmp_save_orphan"))
    ckpt.save(d, 1, {"w": torch.ones(3, 2)})
    assert not [f for f in os.listdir(d) if f.startswith(".tmp_save_")]
    assert os.path.isdir(os.path.join(d, "step_00000001"))


def test_gc_keep_zero_rejected(tmp_path):
    d = str(tmp_path)
    params = {"w": torch.ones(2)}
    with pytest.raises(ValueError, match="keep must be >= 1"):
        ckpt.save(d, 1, params, keep=0)
    assert not os.listdir(d)  # nothing written
    ckpt.save(d, 1, params, keep=1)
    ckpt.save(d, 2, params, keep=1)
    assert [f for f in os.listdir(d) if f.startswith("step_")] == ["step_00000002"]
    with pytest.raises(ValueError, match="keep must be >= 1"):
        ckpt._gc(d, 0)


def test_restore_validates_treedef(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, {"w": torch.ones(3, 2), "b": torch.zeros(2)})
    with pytest.raises(ValueError, match="tree structure"):
        ckpt.restore(d, 1, {"w": torch.ones(3, 2), "c": torch.zeros(2)})


def test_restore_validates_leaf_shapes(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, {"w": torch.ones(3, 2), "b": torch.zeros(2)})
    with pytest.raises(ValueError, match=r"\['params'\]\['b'\]"):
        ckpt.restore(d, 1, {"w": torch.ones(3, 2), "b": torch.zeros(3)})
    p, manifest = ckpt.restore(d, 1, {"w": torch.ones(3, 2, dtype=torch.bfloat16),
                                      "b": torch.zeros(2)})
    assert p["w"].dtype == torch.bfloat16 and manifest["step"] == 1
    assert torch.equal(p["w"].float(), torch.ones(3, 2))


def test_sweep_checkpointer_roundtrip(tmp_path):
    store = SweepCheckpointer(str(tmp_path), keep=2)
    state = {"loss": torch.tensor(1.5), "carry": {"v": torch.arange(4.0)}}
    assert store.restore_latest(state) is None
    for cursor in (1, 2, 3):
        store.save(cursor, state, {"n": 10})
    cur, st, meta = store.restore_latest(state)
    assert cur == 3 and meta["n"] == 10
    assert torch.equal(st["carry"]["v"], torch.arange(4.0))
    kept = sorted(f for f in os.listdir(str(tmp_path)) if f.startswith("step_"))
    assert kept == ["step_00000002", "step_00000003"]
    with pytest.raises(ValueError, match="keep must be >= 1"):
        SweepCheckpointer(str(tmp_path), keep=0)
