"""RWKV6 "Finch" (``RWKV6Block``, ``GroupRMSNorm``, ``token_shift``,
``build_model``'s ``wkv_chunk``): the port on the CPU against the JAX
package.

The reduced RWKV6-3B (two layers of d 64, four heads of 16, the ``wkv``
recurrence with the bonus ``u`` and a per-channel decay) from JAX's ``init``
with every leaf moved off its constant start (the ``mu`` lerps at 0.5, ``w0``
at −4, ``u`` at 0, the norms at 1 would hide a mix-up), carried across with
``bridge.params_from_numpy``:

* logits ≤ 1e-5 of the largest, at wkv chunks of 16 and 4 (the same
  recurrence);
* the serve_step chain (the shifted inputs and the WKV state in the cache)
  against JAX's serve_step and against the full forward;
* ``run`` with the first-order extensions, DiagGGN-MC and KFAC (JAX's draws
  passed in) on the fused and the per-extension route: the gradient and
  every statistic of every leaf within ``TOL`` of the leaf's largest entry
  of JAX's — the ``GroupRMSNorm`` gain's per sample and curvature
  statistics and its input cotangent among them;
* ``GroupRMSNorm`` alone: the grouped mean square, and its sweeps against
  autograd;
* the training launcher on ``--arch rwkv6-3b``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_lm_backpack import FIRST, MC, TOL, _batch, _jax_draws, _jax_run, _np, \
    _port_run, _t

from repro.configs import get_config as jax_get_config
from repro.nn.models import build_model as jax_build_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import ExtensionConfig, by_name
from repro_torch.core.module import GroupRMSNorm
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import train
from repro_torch.nn import functional as F
from repro_torch.nn.models import build_model

ARCH = "rwkv6-3b"


@pytest.fixture(scope="module")
def rwkv():
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jm = jax_build_model(jcfg)
    rs = np.random.RandomState(1)
    jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32) + 0.1 * rs.randn(
        *a.shape).astype(np.float32)), jm.init(jax.random.PRNGKey(0)))
    pm = build_model(cfg, device="cpu")
    return cfg, jm, jp, pm, params_from_numpy(pm, _np(jp), device="cpu")


@pytest.mark.parametrize("chunk", [16, 4])
def test_rwkv_logits_match_jax(rwkv, chunk):
    cfg, jm, jp, pm, pp = rwkv
    toks, _ = _batch(cfg, 2, 32, 0, masked=0)
    want = np.asarray(jm.apply(jp, jnp.asarray(toks)))
    model = pm if chunk == 16 else build_model(cfg, wkv_chunk=chunk, device="cpu")
    got = model.call(pp, _t(toks)).numpy()
    np.testing.assert_allclose(got / np.abs(want).max(), want / np.abs(want).max(),
                               rtol=1e-5, atol=1e-5)


def test_rwkv_decode_chain_matches_jax_and_the_forward(rwkv):
    cfg, jm, jp, pm, pp = rwkv
    toks, _ = _batch(cfg, 2, 12, 1, masked=0)
    jcache = jm.init_serve_cache(jp, 2, 12, jnp.float32)
    cache = pm.init_serve_cache(pp, 2, 12, torch.float32)
    full = pm.call(pp, _t(toks))
    scale = float(full.abs().max())
    for t in range(12):
        jlogits, jcache = jm.serve_step(jp, jcache, jnp.asarray(toks[:, t]), t)
        logits, cache = pm.serve_step(pp, cache, _t(toks[:, t]), t)
        np.testing.assert_allclose(logits.numpy() / scale, np.asarray(jlogits) / scale,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(logits.numpy() / scale, full[:, t].numpy() / scale,
                                   rtol=1e-5, atol=1e-5)
    assert set(cache[0]) == {"x_time", "x_chan", "state"}
    assert tuple(cache[0]["state"].shape) == (2, 2, 4, 16, 16)  # [L, N, H, dk, dv]


def _close_by_leaf(port, want, what):
    """Each leaf within ``TOL`` of its largest entry: from the perturbed start
    the gradients reach 2.4, and float32 through the chunked recurrence's
    exp factors reads ≈ 1e-5 of a leaf (JAX's own ``run`` against
    ``jax.grad`` as much)."""
    port, want = tree_leaves(port), jax.tree.leaves(want)
    assert len(port) == len(want) and want, what
    for a, b in zip(port, want):
        assert tuple(a.shape) == b.shape, what
        scale = max(float(np.abs(b).max()), 1e-12)
        np.testing.assert_allclose(a.numpy() / scale, b / scale, rtol=TOL, atol=TOL,
                                   err_msg=what)


@pytest.mark.parametrize("use_fused", [True, False], ids=["fused", "per_extension"])
def test_rwkv_run_matches_jax(rwkv, use_fused):
    cfg, jm, jp, pm, pp = rwkv
    toks, labels = _batch(cfg, 2, 16, 2)
    names = FIRST + MC
    rng = jax.random.PRNGKey(3)
    want = _jax_run(jm, jp, jnp.asarray(toks), jnp.asarray(labels), names, rng=rng,
                    mc_samples=1, use_fused=use_fused)
    draws = _jax_draws(jnp.asarray(want[2]), jnp.asarray(labels), rng, 1)
    res = _port_run(pm, pp, _t(toks), labels, names, draws=draws, mc_samples=1,
                    use_fused=use_fused)
    np.testing.assert_allclose(res.loss.numpy(), want[0], rtol=1e-5)
    _close_by_leaf(res.logits, [want[2]], "logits")
    _close_by_leaf(res.grads, want[1], "grads")
    assert set(res.ext) == set(names)
    for name in names:
        _close_by_leaf(res.ext[name], want[3][name], name)
    # the stack's per-head norm: the gain's statistics are [N, L, d] / [L, d]
    ln_x = res["batch_grad"][1]["ln_x"]["g"]
    assert tuple(ln_x.shape) == (2, 2, cfg.d_model)
    assert float(res["diag_ggn_mc"][1]["ln_x"]["g"].min()) >= 0


def test_group_rms_norm_against_autograd():
    """The grouped mean square, and the sweeps' input cotangent and gain
    gradient against autograd through ``call``."""
    gen = torch.Generator().manual_seed(0)
    norm = GroupRMSNorm(12, 3, device="cpu")
    params = {"g": torch.randn(12, generator=gen)}
    x = torch.randn(2, 5, 12, generator=gen)
    xg = x.reshape(2, 5, 3, 4)
    want = (xg * torch.rsqrt((xg * xg).mean(-1, keepdim=True) + 1e-6)).reshape(x.shape)
    torch.testing.assert_close(norm.call(params, x), want * params["g"])
    y, tape = norm.forward_tape(params, x)
    cot = torch.randn(y.shape, generator=gen)
    g_x, grads, stats = norm.backward(params, tape, cot, (by_name("batch_grad"),),
                                      ExtensionConfig())
    xa, ga = x.clone().requires_grad_(True), params["g"].clone().requires_grad_(True)
    ax, ag = torch.autograd.grad((norm.call({"g": ga}, xa) * cot).sum(), (xa, ga))
    torch.testing.assert_close(g_x, ax)
    torch.testing.assert_close(grads["g"], ag)
    torch.testing.assert_close(stats["batch_grad"]["g"].sum(0), ag)
    S = torch.randn((3,) + tuple(x.shape), generator=gen)
    rows = norm.jac_t_mat(params, tape, S)
    for c in range(3):
        torch.testing.assert_close(rows[c], torch.autograd.grad(
            (norm.call(params, xa) * S[c]).sum(), xa)[0])


def test_token_shift():
    x = torch.arange(12.0).reshape(1, 4, 3)
    torch.testing.assert_close(F.token_shift(x)[0, 0], torch.zeros(3))
    torch.testing.assert_close(F.token_shift(x)[:, 1:], x[:, :-1])
    last = torch.ones(1, 3)
    torch.testing.assert_close(F.token_shift(x, last)[:, 0], last)


def test_launcher_trains_rwkv():
    run = train.main(["--arch", ARCH, "--seq", "16", "--batch", "2", "--steps", "2",
                      "--optimizer", "diag_ggn_mc", "--device", "cpu"])
    assert run["cfg"].kind == "rwkv"
    assert all(np.isfinite(h["loss"]) for h in run["history"])


def test_rwkv6_3b_full_param_count_matches_jax():
    """The published config's size, the port's counted on the ``meta``
    device (≈ 3.1 billion)."""
    assert get_config(ARCH).param_count() == jax_get_config(ARCH).param_count()
