"""The port's observability layer (``repro_torch.obs``) held against the JAX
package's ``repro.obs`` on the CPU.

* The registry: span nesting and paths, ``set`` mid-span, counters and
  gauges, ``use`` scoping, enable / disable, the JSONL sink's round trip
  (numpy and host tensor scalars land as JSON values; a tensor that is not a
  host scalar is described, never read), a torn last line, the shared no-op
  span.  Ported from ``tests/test_obs.py``.
* The renderer: the same text as ``repro.obs.render`` on the same events,
  and ``python -m repro_torch.obs.reporting`` the same output as
  ``tools/obs_report.py`` on a trace the port wrote.
* The engine: ``SweepPlan.run`` on a tiny MLP and on a Conv2d + MaxPool2d +
  Dense net at 8 × 8 (JAX's weights through ``bridge.params_from_numpy``;
  both sides ``use_kernels=True``: JAX's Pallas kernels in interpret mode,
  the port's plain versions) records JAX's spans (names, paths, attrs) and
  ``kernel.calls.*`` counters, and its results are bit for bit the same
  with obs on and off.  JAX's ``kernel.cache_*`` and
  ``kernel.padding_waste_bytes.*`` have no counterpart (the port has no jit
  cache and no padding).  The accumulated ``run`` (sweep → finalize) and a
  ``stream`` (slices, pairs, the cursor gauge, finalize) record JAX's span
  trees; their ``kernel.calls.*`` differ by design: JAX counts once a trace
  (its slices run in a scan or a jitted function), the port once a call.
* The training loop with checkpoints and an injected fault, fed JAX's
  batches: JAX's ``train/step``, ``ckpt/*`` and ``fault.*`` events and
  counters, but ``ckpt/*``'s ``bytes``, 4 more in the port (its optimizer's
  step count is a Python int, saved as int64 where JAX saves an int32), and
  ``kernel.calls.flash_attention``, which JAX's CPU model does not count
  (its attention is no Pallas call there): pinned to a call a layer a step.
* Laplace's fit, predictives and evidence, the NTK consumers and
  ``generate``: their spans (JAX's names, nesting and attrs), counters and
  gauge; ``generate`` gives the same tokens with obs off.
* ``obs.profile`` on the CPU: one Chrome trace holding the spans as ranges;
  it refuses CUDA activity without a card, and a window inside another.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro import obs as jobs
from repro.core import Activation as JActivation
from repro.core import CrossEntropyLoss as JCrossEntropy
from repro.core import Dense as JDense
from repro.core import ExtensionConfig as JConfig
from repro.core import Sequential as JSequential
from repro.core import by_name as jby_name
from repro.core import plan_sweeps as jplan_sweeps
from repro.nn.layers import Conv2d as JConv2d
from repro.nn.layers import Flatten as JFlatten
from repro.nn.layers import MaxPool2d as JMaxPool2d
from repro_torch import obs
from repro_torch.bridge import params_from_numpy
from repro_torch.core import (
    Activation,
    CrossEntropyLoss,
    Dense,
    ExtensionConfig,
    Sequential,
    by_name,
    plan_sweeps,
)
from repro_torch.core.tree import tree_leaves
from repro_torch.nn.layers import Conv2d, Flatten, MaxPool2d
from repro_torch.obs import NullRegistry, ObsRegistry
from repro_torch.obs import reporting
from repro_torch.obs.reporting import load_jsonl, render

REPO = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(REPO, "src")
TEN = ("batch_grad", "batch_l2", "second_moment", "variance", "batch_dot",
       "diag_ggn", "kflr", "ggn_trace", "diag_ggn_mc", "kfac")
LOSS = CrossEntropyLoss()


@pytest.fixture(autouse=True)
def _clean_registries():
    """Every test starts and ends with both packages' registries disabled."""
    obs.disable()
    jobs.disable()
    yield
    obs.disable()
    jobs.disable()


def _nets(kind):
    """(JAX model, port model, input shape, classes): the tiny MLP of JAX's
    ``tests/test_obs.py`` or a Conv2d + MaxPool2d + Dense net at 8 × 8."""
    if kind == "mlp":
        return (JSequential([JDense(4, 6), JActivation("sigmoid"), JDense(6, 3)]),
                Sequential([Dense(4, 6, device="cpu"), Activation("sigmoid"),
                            Dense(6, 3, device="cpu")]), (8, 4), 3)
    return (JSequential([JConv2d(1, 4, kernel=3, padding="SAME"), JActivation("relu"),
                         JMaxPool2d(2), JFlatten(), JDense(64, 3)]),
            Sequential([Conv2d(1, 4, kernel=3, padding="SAME", device="cpu"),
                        Activation("relu"), MaxPool2d(2), Flatten(),
                        Dense(64, 3, device="cpu")]), (6, 8, 8, 1), 3)


def _problem(kind):
    jmodel, model, shape, c = _nets(kind)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(model, jax.tree.map(np.asarray, jparams), "cpu")
    rs = np.random.RandomState(1)
    x = rs.randn(*shape).astype(np.float32)
    y = rs.randint(0, c, shape[0])
    draws = rs.randint(0, c, (1, shape[0]))  # the MC class draws, given to the port
    return dict(jmodel=jmodel, jparams=jparams, model=model, params=params, x=x, y=y,
                draws=draws)


def _events(reg, kinds=("span", "count", "gauge"), drop=()):
    """The registry's events without their times (``t``, ``dur_s``), of the
    given kinds, without the counters named in ``drop`` (prefixes)."""
    return [{k: v for k, v in e.items() if k not in ("t", "dur_s")}
            for e in reg.events
            if e["kind"] in kinds and not any(e["name"].startswith(p) for p in drop)]


def _kernel_calls(reg):
    return {k: v for k, v in reg.counters.items() if k.startswith("kernel.calls.")}


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def test_span_nesting_paths_and_attrs():
    reg = ObsRegistry()
    with obs.use(reg):
        with obs.span("outer", n=2):
            with obs.span("inner", bytes=128) as sp:
                sp.set(rows=7)
            with obs.span("inner"):
                pass
    spans = [e for e in reg.events if e["kind"] == "span"]
    assert [tuple(e["path"]) for e in spans] == [
        ("outer", "inner"), ("outer", "inner"), ("outer",)]
    assert spans[0]["attrs"] == {"bytes": 128, "rows": 7}
    assert spans[2]["attrs"] == {"n": 2}
    assert all(e["dur_s"] >= 0.0 for e in spans)
    # children accounted inside the parent's duration
    assert spans[2]["dur_s"] >= spans[0]["dur_s"] + spans[1]["dur_s"]


def test_counters_and_gauges():
    reg = ObsRegistry()
    with obs.use(reg):
        obs.count("steps")
        obs.count("steps", 4)
        obs.gauge("cursor", 3)
        obs.gauge("cursor", 9)
    assert reg.counters == {"steps": 5}
    assert reg.gauges == {"cursor": 9}
    assert reg.snapshot() == {"enabled": True, "counters": {"steps": 5},
                              "gauges": {"cursor": 9}, "events": 4}


def test_use_restores_previous_registry_on_error():
    before = obs.get()
    with pytest.raises(RuntimeError):
        with obs.use(ObsRegistry()):
            assert obs.enabled()
            raise RuntimeError("boom")
    assert obs.get() is before
    assert not obs.enabled()


def test_enable_disable_module_registry():
    assert not obs.enabled()
    obs.enable()
    assert obs.enabled()
    obs.count("x")
    assert obs.get().counters == {"x": 1}
    obs.disable()
    assert isinstance(obs.get(), NullRegistry)


@pytest.mark.parametrize("value,want", [
    (np.int64(3), 3.0), (np.float32(0.5), 0.5), (torch.tensor(3), 3), (torch.tensor(0.25), 0.25),
    (torch.tensor(True), True), ("slice", "slice"), (None, None)],
    ids=["np_int", "np_float", "tensor_int", "tensor_float", "tensor_bool", "str", "none"])
def test_jsonl_round_trip(tmp_path, value, want):
    """Every attr value lands as a JSON value: numpy scalars as floats (as
    JAX's ``_clean``), 0-d host tensors as their Python value."""
    trace = str(tmp_path / "trace.jsonl")
    reg = ObsRegistry(trace_jsonl=trace)
    with obs.use(reg):
        with obs.span("work", v=value, tag="slice"):
            obs.count("calls", 2)
        obs.gauge("cursor", 1)
    reg.close()
    events = load_jsonl(trace)
    assert events == list(reg.events)
    (span,) = [e for e in events if e["kind"] == "span"]
    assert span["attrs"] == {"v": want, "tag": "slice"}
    assert type(span["attrs"]["v"]) is type(want)
    assert set(span) == {"kind", "name", "path", "t", "dur_s", "attrs"}
    assert [set(e) for e in events if e["kind"] != "span"] == [{"kind", "name", "value"}] * 2


@pytest.mark.parametrize("value", [torch.ones(3), torch.empty((), device="meta")],
                         ids=["host_vector", "not_on_the_host"])
def test_clean_describes_a_tensor_it_does_not_read(value):
    """A tensor that is not a host scalar is described by its shape, dtype
    and device: reading a card tensor would wait for the card."""
    reg = ObsRegistry()
    with obs.use(reg):
        with obs.span("work", v=value):
            pass
    got = reg.events[0]["attrs"]["v"]
    assert got == (f"tensor(shape={list(value.shape)}, dtype={value.dtype}, "
                   f"device={value.device})")


def test_load_jsonl_tolerates_torn_tail(tmp_path):
    trace = tmp_path / "trace.jsonl"
    trace.write_text(json.dumps({"kind": "count", "name": "a", "value": 1}) + "\n"
                     + '{"kind": "span", "name": "tru')
    events = load_jsonl(str(trace))
    assert len(events) == 1 and events[0]["name"] == "a"


def test_null_registry_is_shared_singleton_noop():
    s1 = obs.span("a", n=1)
    s2 = obs.span("b")
    assert s1 is s2  # one preallocated null span, no per-call allocation
    with s1 as sp:
        sp.set(bytes=4)
    obs.count("c")
    obs.gauge("g", 1)
    assert obs.get().events == ()
    assert obs.get().counters == {}
    assert obs.snapshot() == {"enabled": False, "counters": {}, "gauges": {}, "events": 0}
    assert "disabled" in obs.report()


# ---------------------------------------------------------------------------
# the renderer: JAX's text on the same events
# ---------------------------------------------------------------------------

EVENT_LISTS = {
    "tree": [
        {"kind": "span", "name": "a", "path": ["a"], "dur_s": 0.25,
         "attrs": {"bytes": 100, "step": 7}},
        {"kind": "span", "name": "b", "path": ["a", "b"], "dur_s": 0.1,
         "attrs": {"bytes": 40}},
        {"kind": "span", "name": "b", "path": ["a", "b"], "dur_s": 0.1,
         "attrs": {"bytes": 2}},
        {"kind": "count", "name": "calls", "value": 3},
        {"kind": "gauge", "name": "cursor", "value": 5},
    ],
    # a child whose parent never closed, times in each unit, a bool attr
    "open_parent": [
        {"kind": "span", "name": "slice", "path": ["sweep", "slice"], "dur_s": 2.5e-7,
         "attrs": {"rows": 3, "t": 0, "sharded": False}},
        {"kind": "span", "name": "slice", "path": ["sweep", "slice"], "dur_s": 0.0042,
         "attrs": {"rows": 2, "t": 1, "n": 1.5}},
        {"kind": "span", "name": "other", "path": ["other"], "dur_s": 12.0, "attrs": {}},
        {"kind": "count", "name": "kernel.calls.x", "value": 1},
        {"kind": "count", "name": "kernel.calls.x", "value": 2.5},
        {"kind": "gauge", "name": "s_per_token", "value": 0.0125},
    ],
    "empty": [],
}


@pytest.mark.parametrize("name", sorted(EVENT_LISTS))
def test_render_matches_jax(name):
    events = EVENT_LISTS[name]
    assert render(events) == jobs.render(events)


def test_report_renders_tree_counters_gauges():
    out = render(EVENT_LISTS["tree"])
    lines = out.splitlines()
    (a_line,) = [ln for ln in lines if ln.startswith("a ")]
    (b_line,) = [ln for ln in lines if ln.lstrip().startswith("b ")]
    assert lines.index(b_line) > lines.index(a_line)  # child under parent
    assert "bytes=42" in b_line
    assert "step=" not in a_line  # identifiers are not summed
    assert "calls = 3" in out and "cursor = 5" in out
    assert render([]) == "no events recorded"


def test_reporting_command_matches_tools_obs_report(tmp_path, capsys):
    """A trace the port wrote (a stream's slices, pairs, gauge and finalize):
    ``python -m repro_torch.obs.reporting`` prints what
    ``tools/obs_report.py`` prints, and what the registry's report says."""
    p = _problem("mlp")
    exts = tuple(by_name(n) for n in ("batch_dot", "variance"))
    cfg = ExtensionConfig(use_kernels=True)
    trace = str(tmp_path / "trace.jsonl")
    reg = ObsRegistry(trace_jsonl=trace)
    with obs.use(reg):
        stream = plan_sweeps(exts, cfg).accumulate(4).stream(
            p["model"], p["params"], torch.from_numpy(p["x"]), torch.from_numpy(p["y"]),
            LOSS, cfg=cfg)
        while not stream.done:
            stream.step()
        stream.result()
    reg.close()
    env = dict(os.environ, PYTHONPATH=SRC)
    commands = ([sys.executable, "-m", "repro_torch.obs.reporting", trace],
                [sys.executable, os.path.join(REPO, "tools", "obs_report.py"), trace])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=REPO, env=env) for c in commands]  # both at once
    (port, port_err), (jax_tool, jax_err) = (p_.communicate(timeout=120) for p_ in procs)
    assert [p_.returncode for p_ in procs] == [0, 0], (port_err, jax_err)
    assert port == jax_tool
    assert port.strip() == reg.report() == jobs.render(load_jsonl(trace))
    assert "engine/stream/pair" in port and "engine.stream.cursor = 10" in port
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert reporting.main([str(empty)]) == 1
    assert "no events" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the engine: JAX's spans and kernel counters on the same inputs
# ---------------------------------------------------------------------------

# JAX's counters of its jit cache and padding, which the port has no use for
JAX_ONLY = ("kernel.cache_hit.", "kernel.cache_miss.", "kernel.padding_waste_bytes.")


@pytest.mark.parametrize("kind,fused,names", [
    ("mlp", True, TEN), ("conv", True, ("batch_l2", "variance", "batch_dot", "diag_ggn")),
    ("conv", False, ("batch_l2", "second_moment", "variance", "diag_ggn"))],
    ids=["mlp-fused", "conv-fused", "conv-per_extension"])
def test_monolithic_run_records_jax_spans_and_kernel_calls(kind, fused, names):
    p = _problem(kind)
    jcfg = JConfig(use_kernels=True, use_fused=fused, mc_samples=1)
    jreg = jobs.ObsRegistry()
    with jobs.use(jreg):
        jplan_sweeps(tuple(jby_name(n) for n in names), jcfg).run(
            p["jmodel"], p["jparams"], jnp.asarray(p["x"]), jnp.asarray(p["y"]),
            JCrossEntropy(), cfg=jcfg, rng=jax.random.PRNGKey(3))
    cfg = ExtensionConfig(use_kernels=True, use_fused=fused, mc_samples=1)
    plan = plan_sweeps(tuple(by_name(n) for n in names), cfg)
    args = (p["model"], p["params"], torch.from_numpy(p["x"]), torch.from_numpy(p["y"]), LOSS)
    off = plan.run(*args, cfg=cfg, rng=torch.from_numpy(p["draws"]))
    reg = ObsRegistry()
    with obs.use(reg):
        on = plan.run(*args, cfg=cfg, rng=torch.from_numpy(p["draws"]))
    assert _events(reg) == _events(jreg, drop=JAX_ONLY)
    assert reg.counters == {k: v for k, v in jreg.counters.items()
                            if not k.startswith(JAX_ONLY)}
    assert _kernel_calls(reg)  # the kernel route was taken
    for a, b in zip(tree_leaves((off.loss, off.grads, off.logits, off.ext)),
                    tree_leaves((on.loss, on.grads, on.logits, on.ext)), strict=True):
        assert torch.equal(a, b)


ACC_NAMES, ACC_K = ("batch_dot", "diag_ggn", "kfac"), 4


def _accumulated(p, jreg, reg, drive):
    """JAX's and the port's accumulated sweep of ``ACC_NAMES`` in ``ACC_K``
    slices, each into its registry: ``plan.run`` or (``drive``) a stream
    stepped to its end and finalized.  Returns the port's stream."""
    jcfg = JConfig(use_kernels=True, mc_samples=1)
    jplan = jplan_sweeps(tuple(jby_name(n) for n in ACC_NAMES), jcfg).accumulate(ACC_K)
    jargs = (p["jmodel"], p["jparams"], jnp.asarray(p["x"]), jnp.asarray(p["y"]),
             JCrossEntropy())
    cfg = ExtensionConfig(use_kernels=True, mc_samples=1)
    plan = plan_sweeps(tuple(by_name(n) for n in ACC_NAMES), cfg).accumulate(ACC_K)
    args = (p["model"], p["params"], torch.from_numpy(p["x"]), torch.from_numpy(p["y"]), LOSS)
    draws = torch.from_numpy(p["draws"])
    with jobs.use(jreg):
        if drive:
            js = jplan.stream(*jargs, cfg=jcfg, rng=jax.random.PRNGKey(3))
            while not js.done:
                js.step()
            js.result()
        else:
            jplan.run(*jargs, cfg=jcfg, rng=jax.random.PRNGKey(3))
    stream = plan.stream(*args, cfg=cfg, rng=draws)
    with obs.use(reg):
        if drive:
            while not stream.done:
                stream.step()
            stream.result()
        else:
            plan.run(*args, cfg=cfg, rng=draws)
    return stream


def _calls_of_slices(p, stream):
    """The port's ``kernel.calls.*`` over the stream's slices and pair passes
    run one by one as monolithic calls."""
    reg = ObsRegistry()
    with obs.use(reg):
        for unit in stream.units:
            stream._run_unit(unit)
    return _kernel_calls(reg)


@pytest.mark.parametrize("drive", [False, True], ids=["run", "stream"])
def test_accumulated_lane_records_jax_span_tree(drive):
    """``run``: engine/sweep (accumulated, k, n) → engine/finalize per carried
    extension, no unit spans (JAX's run is one scan).  A stream driven unit by
    unit: a slice or pair span a unit, the cursor gauge after each, then
    finalize.  ``kernel.calls.*``: the port counts each call its slices and
    pairs make; JAX counts once a trace, so fewer."""
    p = _problem("mlp")
    jreg, reg = jobs.ObsRegistry(), ObsRegistry()
    stream = _accumulated(p, jreg, reg, drive)
    assert _events(reg, drop=("kernel.",)) == _events(jreg, drop=("kernel.",))
    spans = [e["name"] for e in reg.events if e["kind"] == "span"]
    pairs = len(stream.units) - stream.n_slices
    assert pairs > 0 and stream.carry_names
    if drive:
        assert spans.count("engine/stream/slice") == stream.n_slices
        assert spans.count("engine/stream/pair") == pairs
        assert reg.gauges == {"engine.stream.cursor": len(stream.units)}
    else:
        assert spans == ["engine/finalize"] * len(stream.carry_names) + ["engine/sweep"]
        sweep = reg.events[-1]
        assert sweep["attrs"] == {"lane": "accumulated", "k": ACC_K, "n": 8,
                                  "extensions": ",".join(sorted(ACC_NAMES))}
    calls = _kernel_calls(reg)
    assert calls == _calls_of_slices(_problem("mlp"), stream)
    jcalls = _kernel_calls(jreg)
    assert set(jcalls) == set(calls)
    assert all(jcalls[k] < calls[k] for k in calls)


# ---------------------------------------------------------------------------
# training with checkpoints and a fault; Laplace, an NTK consumer, serving
# ---------------------------------------------------------------------------


def test_fit_with_checkpoints_and_a_fault_records_jax_events(tmp_path, monkeypatch):
    """Three AdamW steps of a one-layer LM, a checkpoint a step, a failure
    injected at step 2 and one restart: the port's events are JAX's, fed
    JAX's batches, but for the ``bytes`` of ``ckpt/*`` and the port's
    attention counter."""
    import dataclasses

    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jax_get_config
    from repro.data import synthetic as jsyn
    from repro.nn.models import build_model as jax_build_model
    from repro.optim import adamw as jadamw
    from repro.train import loop as jloop
    from repro.train.fault import FailureInjector as JFailureInjector
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.nn.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    from repro_torch.train.fault import FailureInjector

    arch, steps = "stablelm-1.6b", 3
    tiny = dict(name="tiny", n_layers=1, d_model=32, n_heads=2, kv_heads=2, head_dim=16,
                d_ff=64, vocab=64)
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **tiny)
    cfg = dataclasses.replace(get_config(arch).reduced(), **tiny)
    jshape = dataclasses.replace(JSHAPES["train_4k"], seq_len=8, global_batch=2)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=8, global_batch=2)
    jmodel, model = jax_build_model(jcfg), build_model(cfg, device="cpu")
    params = params_from_numpy(
        model, jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))), "cpu")
    batches = [jax.tree.map(np.array, jsyn.batch_for(jcfg, jshape, s)) for s in range(steps)]
    monkeypatch.setattr(loop, "batch_for", lambda cfg, shape, step, seed=0, batch=None,
                        device="cuda": jax.tree.map(torch.from_numpy, batches[step]))

    def silent(*_):
        pass

    jreg, reg = jobs.ObsRegistry(), ObsRegistry()
    with jobs.use(jreg):
        jloop.fit_with_restarts(
            jmodel, jcfg, jshape, jadamw(1e-3),
            jloop.LoopConfig(steps=steps, ckpt_dir=str(tmp_path / "j"), ckpt_every=1),
            max_restarts=1, injector=JFailureInjector(fail_at_step=2), log_fn=silent)
    with obs.use(reg):
        loop.fit_with_restarts(
            model, cfg, shape, adamw(1e-3),
            loop.LoopConfig(steps=steps, ckpt_dir=str(tmp_path / "t"), ckpt_every=1),
            max_restarts=1, injector=FailureInjector(fail_at_step=2), log_fn=silent,
            params=params)

    def without_bytes(events):
        return [dict(e, attrs={k: v for k, v in e["attrs"].items() if k != "bytes"})
                if e["kind"] == "span" else e for e in events]

    port = _events(reg, drop=("kernel.",))
    want = _events(jreg)
    assert without_bytes(port) == without_bytes(want)
    assert [e["name"] for e in want if e["kind"] == "span"].count("train/step") == steps
    assert reg.counters == dict(jreg.counters, **{"kernel.calls.flash_attention": steps})
    assert reg.counters["fault.restarts"] == 1 and reg.counters["ckpt.restores"] == 1
    for a, b in zip(port, want):
        if "bytes" in b.get("attrs", {}):
            assert a["attrs"]["bytes"] == b["attrs"]["bytes"] + 4, a["name"]


def _tree(reg):
    """(path, attrs) of each span, in the order they closed."""
    return [(tuple(e["path"]), e["attrs"]) for e in reg.events if e["kind"] == "span"]


def test_laplace_fit_and_predictive_record_their_spans():
    """JAX's span names, nesting and attrs (``laplace/posterior.py:189, 691``,
    ``predictive.py:234, 248``, ``marglik.py:170``)."""
    from repro_torch.laplace import fit_posterior, glm_predictive, mc_predictive, optimize_marglik

    p = _problem("mlp")
    x, y = torch.from_numpy(p["x"]), torch.from_numpy(p["y"])
    reg = ObsRegistry()
    with obs.use(reg):
        post = fit_posterior(p["model"], p["params"], x, y, LOSS, structure="diag")
        glm_predictive(p["model"], p["params"], post, x)
        optimize_marglik(post, n_steps=3)
        mc_predictive(p["model"], p["params"], post, x, torch.Generator().manual_seed(0),
                      n_samples=2)
        fit_posterior(p["model"], p["params"], x, y, LOSS, structure="kron", last_layer=True)
    fit, sweep = ("laplace/fit",), ("laplace/fit", "laplace/fit_sweep")
    assert _tree(reg)[:6] == [
        (sweep + ("engine/sweep",), {"lane": "monolithic", "extensions": "diag_ggn"}),
        (sweep, {"n": 8, "extensions": "diag_ggn"}),
        (fit, {"structure": "diag", "last_layer": False}),
        (("laplace/predictive/glm",), {"n": 8, "use_kernels": True}),
        (("laplace/marglik",), {"n_steps": 3, "tune_sigma": False}),
        (("laplace/predictive/mc",), {"n": 8, "n_samples": 2})]
    assert _tree(reg)[-1] == (fit, {"structure": "kron", "last_layer": True})
    assert reg.counters == {"kernel.calls.sq_matmul": 2}  # the DiagGGN sweep: one a Dense


def test_ntk_consumers_record_their_spans():
    """``gp_predict`` (its kernel, sweep and two solves) and the influence
    pair, with JAX's names, nesting and attrs (``ntk_apps/regression.py:82,
    108, 181``, ``influence.py:118, 124, 151, 157``); ``sharded`` is False
    until the sharded lane is ported."""
    from repro_torch.ntk_apps import gp_predict, influence_scores, self_influence

    p = _problem("mlp")
    x, y = torch.from_numpy(p["x"]), torch.from_numpy(p["y"])
    reg = ObsRegistry()
    with obs.use(reg):
        gp_predict(p["model"], p["params"], x[:6], y[:6], x[6:], LOSS, ridge=1.0)
    gp = ("ntk_apps/gp_predict",)
    kernel = gp + ("ntk_apps/kernel",)
    assert _tree(reg) == [
        (kernel + ("engine/sweep",), {"lane": "monolithic", "extensions": "ntk"}),
        (kernel, {"n": 8, "sharded": False, "microbatches": 1}),
        (gp + ("ntk_apps/kernel_solve",), {"solver": "cholesky", "n": 6, "rank": 0}),
        (gp + ("ntk_apps/kernel_solve",), {"solver": "cholesky", "n": 6, "rank": 0}),
        (gp, {"n_train": 6, "n_test": 2, "solver": "cholesky"})]
    reg = ObsRegistry()
    with obs.use(reg):
        influence_scores(p["model"], p["params"], x[:6], y[:6], x[6:], y[6:], LOSS,
                         cg_maxiter=2, microbatches=2)
        self_influence(p["model"], p["params"], x[:6], y[:6], LOSS, cg_maxiter=2)
    names = [path for path, _ in _tree(reg) if path[-1].startswith("ntk_apps/")]
    assert names == [("ntk_apps/influence", "ntk_apps/influence/solve"), ("ntk_apps/influence",),
                     ("ntk_apps/self_influence", "ntk_apps/influence/solve"),
                     ("ntk_apps/self_influence",)]
    attrs = dict(_tree(reg))
    assert attrs[("ntk_apps/influence",)] == {"n_train": 6, "n_test": 2, "microbatches": 2}
    assert attrs[("ntk_apps/self_influence",)] == {"n_train": 6, "microbatches": 1}


def test_generate_records_its_spans_counters_and_gauge():
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.nn.models import build_model
    from repro_torch.serve.engine import ServeConfig, generate

    cfg = dataclasses.replace(get_config("stablelm-1.6b").reduced(), n_layers=1, d_model=32,
                              n_heads=2, kv_heads=2, head_dim=16, d_ff=64, vocab=64)
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    prompts = torch.randint(0, 64, (3, 4), generator=torch.Generator().manual_seed(1))
    scfg = ServeConfig(max_len=9)
    off = generate(model, model.params(), prompts, scfg)
    reg = ObsRegistry()
    with obs.use(reg):
        on = generate(model, model.params(), prompts, scfg)
    assert torch.equal(on, off)
    assert _events(reg, kinds=("span",)) == [
        {"kind": "span", "name": "serve/prefill", "path": ["serve/prefill"],
         "attrs": {"n": 3, "tokens": 4}},
        {"kind": "span", "name": "serve/decode", "path": ["serve/decode"],
         "attrs": {"n": 3, "tokens": 5}}]
    assert reg.counters == {"kernel.calls.flash_attention": 4 + 5,
                            "serve.requests": 3, "serve.tokens": 15}
    assert set(reg.gauges) == {"serve.decode.s_per_token"}
    assert reg.gauges["serve.decode.s_per_token"] > 0


# ---------------------------------------------------------------------------
# obs.profile on torch.profiler
# ---------------------------------------------------------------------------


def test_profile_writes_a_chrome_trace_with_the_spans_as_ranges(tmp_path):
    from repro_torch.obs.profile import TRACE_FILE

    reg = ObsRegistry()
    with obs.use(reg):
        with obs.profile(str(tmp_path / "prof"), cuda=False):
            with obs.span("work/outer"):
                with obs.span("work/inner"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
        with obs.span("work/after"):
            pass
    trace = json.loads((tmp_path / "prof" / TRACE_FILE).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"obs/profile", "work/outer", "work/inner"} <= names
    assert "work/after" not in names  # no range once the window closed
    spans = _events(reg, kinds=("span",))
    assert [tuple(e["path"]) for e in spans] == [
        ("obs/profile", "work/outer", "work/inner"), ("obs/profile", "work/outer"),
        ("obs/profile",), ("work/after",)]
    assert spans[2]["attrs"] == {"dir": str(tmp_path / "prof")}


@pytest.mark.parametrize("case", ["no_dir", "cuda_without_card", "nested"])
def test_profile_no_op_and_refusals(tmp_path, monkeypatch, case):
    reg = ObsRegistry()
    with obs.use(reg):
        if case == "no_dir":
            for falsy in (None, ""):
                with obs.profile(falsy):
                    pass
            assert reg.events == [] and list(tmp_path.iterdir()) == []
        elif case == "cuda_without_card":
            monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
            with pytest.raises(RuntimeError, match="CUDA activity was asked for"):
                with obs.profile(str(tmp_path / "p"), cuda=True):
                    pass
            assert not (tmp_path / "p").exists()
        else:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                with pytest.raises(RuntimeError, match="cannot nest"):
                    with obs.profile(str(tmp_path / "p"), cuda=False):
                        pass
            assert reg.events == []
