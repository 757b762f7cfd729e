"""The training launcher, ``serve --uncertainty`` and the LM examples on the
CPU.

``repro_torch.launch.train.main`` with ``--device cpu`` on the reduced
StableLM-2 (2 sequences of 8 tokens, 2 steps) with each optimizer, the
accumulated lane (``--microbatch-size``: the same losses as the whole batch),
``--track-variance``, checkpoint and resume, the restart loop after an
injected failure (the uninterrupted run's losses bit for bit), the obs flags
(``--trace-jsonl`` writes the trace, ``--metrics-report`` prints the report,
``--profile-dir`` holds a Chrome trace with the steps as ranges), and
``--shard-sweep``, whose lane is still to port (it raises, naming its ROADMAP
item); the default device is the card, which raises here.  ``serve_uncertainty``
against JAX's from the same parameters (``bridge``), calibration batch and
MC draws: the next-token mean and variance within 1e-4.  Each LM example's
``main`` with its config swapped for a small one.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_loop import _draws_into_fits

from repro.configs import get_config as jax_get_config
from repro.data import synthetic as jsyn
from repro.launch import serve as jserve
from repro.nn.models import build_model as jax_build_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data import synthetic as syn
from repro_torch.examples import curvature_training, laplace_uncertainty, noise_scale
from repro_torch.launch import serve, train
from repro_torch.nn.models import build_model
from repro_torch.obs import enabled as obs_enabled
from repro_torch.obs.reporting import load_jsonl

ARCH = "stablelm-1.6b"
SMALL = ["--arch", ARCH, "--seq", "8", "--batch", "2", "--steps", "2", "--device", "cpu"]
TINY = dataclasses.replace(get_config(ARCH).reduced(), name="tiny", n_layers=1, d_model=32,
                           n_heads=2, kv_heads=2, head_dim=16, d_ff=64, vocab=64)


def _losses(run):
    return [h["loss"] for h in run["history"]]


@pytest.mark.parametrize("opt", ["adamw", "momentum", "diag_ggn_mc", "kfac", "cg_ngd"])
def test_launcher_trains_with_each_optimizer(opt, capsys):
    run = train.main(SMALL + ["--optimizer", opt, "--cg-iters", "2"])
    losses = _losses(run)
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert run["cfg"].n_layers == 2 and run["params"][0]["emb"]["w"].device.type == "cpu"
    if opt == "cg_ngd":
        assert all(h["cg_iters"] == 2 for h in run["history"])
    assert "final loss" in capsys.readouterr().out


@pytest.mark.parametrize("opt", ["adamw", "diag_ggn_mc"])
def test_launcher_microbatches_give_the_whole_batch_losses(opt, capsys):
    """The plain step accumulates over even slices; the extended step runs
    the accumulated lane: either way the same losses."""
    whole = _losses(train.main(SMALL + ["--optimizer", opt]))
    sliced = _losses(train.main(SMALL + ["--optimizer", opt, "--microbatch-size", "1"]))
    np.testing.assert_allclose(sliced, whole, rtol=1e-5)
    assert "[accumulate] microbatch_size=1 (2 microbatches per step)" in capsys.readouterr().out


def test_launcher_tracks_the_variance():
    run = train.main(SMALL + ["--optimizer", "kfac", "--track-variance"])
    assert all(h["variance_mean"] > 0 for h in run["history"])


def test_launcher_checkpoint_resume_and_restart(tmp_path, capsys):
    args = SMALL[:-4] + ["--steps", "3", "--device", "cpu"]
    whole = _losses(train.main(args + ["--ckpt", str(tmp_path / "a")]))
    train.main(SMALL + ["--ckpt", str(tmp_path / "b")])
    resumed = _losses(train.main(args + ["--ckpt", str(tmp_path / "b"), "--resume"]))
    assert resumed == whole[2:]
    restarted = _losses(train.main(args + ["--ckpt", str(tmp_path / "c"), "--fail-at-step", "1",
                                           "--max-restarts", "1"]))
    assert restarted == whole
    out = capsys.readouterr().out
    assert "[resume] step 2" in out and "[restart 1] after: injected failure at step 1" in out
    with pytest.raises(ValueError, match="needs loop.ckpt_dir"):
        train.main(SMALL + ["--max-restarts", "1"])


@pytest.mark.parametrize("flag,item", [(["--shard-sweep"], "item 12")])
def test_launcher_flags_still_to_port_raise(flag, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue A {item}"):
        train.main(SMALL + flag)


@pytest.mark.parametrize("flag", ["--trace-jsonl", "--metrics-report", "--profile-dir"])
def test_launcher_obs_flags_work_on_the_cpu(flag, tmp_path, capsys):
    """Each obs flag records the run (two ``train/step`` spans, the
    ``train.steps`` counter) and the launcher disables the registry after."""
    path = str(tmp_path / ("t.jsonl" if flag == "--trace-jsonl" else "prof"))
    train.main(SMALL + ([flag] if flag == "--metrics-report" else [flag, path]))
    out = capsys.readouterr().out
    assert not obs_enabled()
    if flag == "--trace-jsonl":
        events = load_jsonl(path)
        steps = [e["attrs"]["step"] for e in events
                 if e["kind"] == "span" and e["name"] == "train/step"]
        assert steps == [0, 1]
        assert sum(e["value"] for e in events if e["name"] == "train.steps") == 2
        assert f"[obs] trace written to {path}" in out
    elif flag == "--metrics-report":
        assert "train/step" in out and "train.steps = 2" in out
    else:
        trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
        names = [e.get("name") for e in trace["traceEvents"]]
        assert names.count("train/step") == 2 and "obs/profile" in names
        assert "[obs] torch.profiler trace in" in out


def test_launcher_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        train.main(SMALL[:-2])


def test_serve_uncertainty_matches_jax(monkeypatch):
    """The diagonal last-layer Laplace endpoint: JAX's parameters, its
    calibration batch (``lm_batch(..., 0)``) and its MC draws (``PRNGKey(0)``
    over the calibration logits) passed in, 5 evidence steps; mean and
    variance ≤ 1e-4."""
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    prompts = np.random.RandomState(0).randint(0, cfg.vocab, (3, 6)).astype(np.int32)
    jmean, jvar, _ = jserve.serve_uncertainty(jcfg, jmodel, jparams, jnp.asarray(prompts),
                                              marglik_steps=5, log_fn=lambda *_: None)
    calib = jsyn.lm_batch(jsyn.DataConfig(vocab=cfg.vocab, seq_len=6, global_batch=3), 0)
    z = jmodel.apply(jparams, calib["inputs"]).astype(jnp.float32)
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(jax.random.PRNGKey(0),
                                                           jnp.arange(3))
    draws = jnp.moveaxis(jax.vmap(lambda k, zn, yn: jax.random.categorical(
        k, zn, axis=-1, shape=(1,) + yn.shape))(keys, z, calib["labels"]), 1, 0)
    monkeypatch.setattr(syn, "lm_batch", lambda dc, step, device="cuda": {
        k: torch.from_numpy(np.asarray(v)) for k, v in calib.items()})
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(model, jax.tree.map(np.asarray, jparams), "cpu")
    _draws_into_fits(monkeypatch, np.asarray(draws))
    log = []
    mean, var, probs = serve.serve_uncertainty(cfg, model, params, torch.from_numpy(prompts),
                                               marglik_steps=5, log_fn=log.append)
    for got, want in ((mean, jmean), (var, jvar)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(np.asarray(want)).max()))
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert log[0].startswith("[laplace] log-evidence") and log[1].startswith("  prompt 0: tok")


def test_curvature_training_example(monkeypatch):
    monkeypatch.setattr(curvature_training, "CFG_100M", TINY)
    hists = curvature_training.main(["--steps", "2", "--seq", "8", "--batch", "2",
                                     "--device", "cpu"])
    assert sorted(hists) == ["adamw", "diag_ggn_mc", "kfac"]
    assert all(len(h) == 2 and np.isfinite(h[-1]["loss"]) for h in hists.values())
    # the three runs start from the same weights and the same first batch
    assert len({h[0]["loss"] for h in hists.values()}) == 1


def test_noise_scale_example(monkeypatch):
    monkeypatch.setattr(noise_scale, "CFG", TINY)
    monkeypatch.setattr(noise_scale, "STEPS", 3)
    rows = noise_scale.main(["--device", "cpu"])
    assert [r[0] for r in rows] == [0, 1, 2]
    assert all(np.isfinite(r[1]) and r[2] > 0 for r in rows)


def test_laplace_uncertainty_example(monkeypatch, capsys):
    monkeypatch.setattr(laplace_uncertainty, "CFG", TINY)
    mean, var = laplace_uncertainty.main(["--steps", "20", "--seq", "8", "--batch", "2",
                                          "--device", "cpu"])
    assert mean.shape == var.shape == (2, TINY.vocab) and (var > 0).all()
    out = capsys.readouterr().out
    assert "[marglik] step    19 log-evidence" in out and "confidence shrink" in out
