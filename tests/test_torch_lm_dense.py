"""The port's dense language models on the CPU, against the JAX package.

The same numpy inputs (made from a seed) and the same parameters (JAX's
``init``, copied across with ``repro_torch.bridge.params_from_numpy``) go
through the JAX function and the port's:

* ``LayerNorm``: ``call``, ``backward`` (input cotangent, grads, every
  first-order statistic), ``curv_backward`` (its GGN diagonal) and
  ``jac_t_mat``;
* partial RoPE at StableLM-2's 16 of 64 dims;
* ``AttnBlock`` with LayerNorm, qkv biases and the non-GLU feed-forward,
  ``call`` and the ``wire_step`` chain;
* ``sdpa_chunked`` (several query and key blocks, windows, GQA) and a block
  built with ``attn_impl="chunked"``;
* ``build_model`` for the five dense configs, reduced: logits (internvl2
  through ``PrefixEmbed``), the greedy decode chain against the full forward
  and JAX's ``serve_step`` (stablelm and gemma3, across gemma3's window-8
  ring wrap), ``generate``; and each config's full-size ``param_count``.

Tolerances (float32, sums in another order): 3e-5 for attention, RoPE and
the norms, 1e-4 for block outputs and model logits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import ExtensionConfig as JConfig
from repro.core import by_name as jby_name
from repro.core import module as jmod
from repro.nn import blocks as jblocks
from repro.nn import functional as JF
from repro.nn.models import build_model as jax_build_model
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import generate as jax_generate
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import ExtensionConfig, by_name
from repro_torch.core import module as pmod
from repro_torch.core.tree import tree_leaves
from repro_torch.nn import blocks as pblocks
from repro_torch.nn import functional as PF
from repro_torch.nn.models import PrefixEmbed, build_model
from repro_torch.serve.engine import ServeConfig, generate
from repro_torch.train import make_decode_step, make_prefill_step

ATTN_TOL = 3e-5
LOGIT_TOL = 1e-4
DENSE = ("stablelm-1.6b", "codeqwen1.5-7b", "internvl2-2b", "h2o-danube-3-4b", "gemma3-12b")
FIRST = ("batch_grad", "batch_l2", "second_moment", "variance", "batch_dot")


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(port, want, tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(want), rtol=tol, atol=tol)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(jax_module, port_module, seed=0):
    """JAX's init copied into the port's module; (jax params, port params)."""
    jp = jax_module.init(jax.random.PRNGKey(seed))
    return jp, params_from_numpy(port_module, _np(jp), device="cpu")


def _close_trees(port, want, tol):
    got, ref = tree_leaves(port), jax.tree.leaves(want)
    assert len(got) == len(ref) and ref
    for a, b in zip(got, ref):
        assert tuple(a.shape) == b.shape
        _close(a, b, tol)


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------


def _layernorm_pair():
    jn, pn = jmod.LayerNorm(12), pmod.LayerNorm(12, device="cpu")
    jp = {"g": jnp.asarray(1 + 0.3 * _rand(1, 12)), "b": jnp.asarray(_rand(2, 12))}
    return jn, pn, jp, params_from_numpy(pn, _np(jp), device="cpu")


def test_layernorm_call_and_backward_match_jax():
    jn, pn, jp, pp = _layernorm_pair()
    x, g = _rand(3, 3, 5, 12), _rand(4, 3, 5, 12)
    _close(pn.call(pp, _t(x)), jn.apply(jp, jnp.asarray(x)), ATTN_TOL)
    assert set(pp) == {"b", "g"} and torch.equal(pmod.LayerNorm(4, device="cpu").g,
                                                 torch.ones(4))
    exts_j, exts_p = tuple(jby_name(e) for e in FIRST), tuple(by_name(e) for e in FIRST)
    _, jtape = jn.forward_tape(jp, jnp.asarray(x))
    jgx, jgrads, jstats = jn.backward(jp, jtape, jnp.asarray(g), exts_j, JConfig())
    _, ptape = pn.forward_tape(pp, _t(x))
    pgx, pgrads, pstats = pn.backward(pp, ptape, _t(g), exts_p, ExtensionConfig())
    _close(pgx, jgx, ATTN_TOL)
    _close_trees(pgrads, jgrads, ATTN_TOL)
    assert set(pstats) == set(jstats)
    for k in jstats:
        _close_trees(pstats[k], jstats[k], 1e-4)


def test_layernorm_curv_backward_and_jac_t_mat_match_jax():
    jn, pn, jp, pp = _layernorm_pair()
    x, S = _rand(5, 3, 5, 12), _rand(6, 4, 3, 5, 12)
    _, jtape = jn.forward_tape(jp, jnp.asarray(x))
    _, ptape = pn.forward_tape(pp, _t(x))
    for prefix, name in (("exact", "diag_ggn"), ("mc", "diag_ggn_mc")):
        jS, jcv = jn.curv_backward(jp, jtape, jnp.asarray(S), (jby_name(name),), JConfig(),
                                   prefix)
        pS, pcv = pn.curv_backward(pp, ptape, _t(S), (by_name(name),), ExtensionConfig(),
                                   prefix)
        _close(pS, jS, ATTN_TOL)
        _close_trees(pcv[name], jcv[name], 1e-4)
    _close(pn.jac_t_mat(pp, ptape, _t(S)), jn.jac_t_mat(jp, jtape, jnp.asarray(S)), ATTN_TOL)


# ---------------------------------------------------------------------------
# AttnBlock variants
# ---------------------------------------------------------------------------


def test_partial_rope_matches_jax_at_stablelm_width():
    """StableLM-2: RoPE on 16 of the 64 dims of a head, with rope_freqs(16)."""
    jb = jblocks.AttnBlock(256, 4, 4, 64, rope_pct=0.25)
    pb = pblocks.AttnBlock(256, 4, 4, 64, rope_pct=0.25, device="cpu")
    assert pb.dh == 64
    x = _rand(0, 2, 7, 4, 64)
    for pos in (np.arange(7) + 2, 9):
        want = jb._rope(jnp.asarray(x), jnp.asarray(pos))
        got = pb._rope(_t(x), torch.as_tensor(pos))
        _close(got, want, ATTN_TOL)
        _close(got[..., 16:], x[..., 16:], 0)  # the other 48 dims pass through
    odd = pblocks.AttnBlock(40, 2, 2, 16, rope_pct=0.3, device="cpu")  # rot 6 of 20
    jodd = jblocks.AttnBlock(40, 2, 2, 16, rope_pct=0.3)
    y = _rand(1, 1, 3, 2, 20)
    _close(odd._rope(_t(y), torch.arange(3)), jodd._rope(jnp.asarray(y), jnp.arange(3)),
           ATTN_TOL)


VARIANTS = {
    "stablelm": dict(norm="layernorm", qkv_bias=True, rope_pct=0.25),
    "nonglu_gelu": dict(norm="layernorm", glu=False, act="gelu"),
    "qkv_bias_window": dict(qkv_bias=True, window=4, rope_theta=1e6),
    "chunked": dict(norm="layernorm", attn_impl="chunked"),
}


def _decode_chain(block, params, x, jax_side):
    n, t = x.shape[:2]
    if jax_side:
        cache = block.init_cache(params, n, t, jnp.float32)
        step = jax.jit(lambda p, xp, c: block.decode_step(p, xp, c))
        outs = []
        for i in range(t):
            (y, _), cache = step(params, (x[:, i:i + 1], jnp.asarray(i, jnp.int32)), cache)
            outs.append(np.asarray(y))
        return np.concatenate(outs, 1)
    cache = block.init_cache(params, n, t, torch.float32)
    outs = []
    for i in range(t):
        (y, _), cache = block.decode_step(params, (x[:, i:i + 1], torch.tensor(i)), cache)
        outs.append(y.numpy())
    return np.concatenate(outs, 1)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_attn_block_variants_match_jax(variant):
    kw = dict(head_dim=8, **VARIANTS[variant])
    jb = jblocks.AttnBlock(32, 4, 2, 48, **kw)
    pb = pblocks.AttnBlock(32, 4, 2, 48, device="cpu", **kw)
    jp, pp = _pair(jb, pb, seed=3)
    assert set(pp) == set(jp)
    if not kw.get("glu", True):
        assert "w_gate" not in pp and "b" in pp["w_up"] and "b" in pp["w_down"]
    if kw.get("qkv_bias"):
        assert all("b" in pp[n] for n in ("wq", "wk", "wv")) and "b" not in pp["wo"]
    # biases are zeros at init: give them values, so that they count
    rs = np.random.RandomState(9)
    jp = jax.tree.map(lambda a: a + 0.1 * rs.randn(*a.shape).astype(np.float32)
                      if a.ndim == 1 else a, jp)
    pp = params_from_numpy(pb, _np(jp), device="cpu")
    x = _rand(4, 2, 10, 32)
    want = jb.apply(jp, jnp.asarray(x))
    _close(pb.call(pp, _t(x)), want, LOGIT_TOL)
    dec_p = _decode_chain(pb, pp, _t(x), False)
    _close(dec_p, _decode_chain(jb, jp, jnp.asarray(x), True), LOGIT_TOL)
    _close(dec_p, want, LOGIT_TOL)


SDPA_CHUNKED = {
    "blocks": dict(t=12, s=12, kv=2, g=2, q_chunk=4, k_chunk=6),
    "window": dict(t=16, s=16, kv=1, g=3, q_chunk=8, k_chunk=4, window=5),
    "ragged": dict(t=10, s=10, kv=2, g=1, q_chunk=4, k_chunk=3),  # chunks shrink to 2, 2
    "noncausal": dict(t=6, s=9, kv=2, g=2, q_chunk=3, k_chunk=3, causal=False),
    "positions": dict(t=4, s=10, kv=2, g=2, q_chunk=2, k_chunk=5, window=6, positions=True),
}


@pytest.mark.parametrize("case", sorted(SDPA_CHUNKED))
def test_sdpa_chunked_matches_jax(case):
    c = dict(SDPA_CHUNKED[case])
    n, dh = 2, 8
    q = _rand(1, n, c["t"], c["kv"] * c["g"], dh)
    k, v = _rand(2, n, c["s"], c["kv"], dh), _rand(3, n, c["s"], c["kv"], dh)
    kw = dict(causal=c.get("causal", True), window=c.get("window"), q_chunk=c["q_chunk"],
              k_chunk=c["k_chunk"])
    jkw, pkw = dict(kw), dict(kw)
    if c.get("positions"):
        qp = np.array([5, 6, 7, 8], np.int32)
        kp = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, -1], np.int32)
        jkw.update(q_positions=jnp.asarray(qp), k_positions=jnp.asarray(kp))
        pkw.update(q_positions=_t(qp), k_positions=_t(kp))
    want = JF.sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw)
    got = PF.sdpa_chunked(_t(q), _t(k), _t(v), **pkw)
    _close(got, want, ATTN_TOL)
    pkw.pop("q_chunk"), pkw.pop("k_chunk")
    _close(got, PF.sdpa(_t(q), _t(k), _t(v), **pkw), ATTN_TOL)


# ---------------------------------------------------------------------------
# the five dense configs, reduced
# ---------------------------------------------------------------------------


_MODELS = {}


def _models(arch):
    """(cfg, JAX model, JAX params, port model, port params), built once."""
    if arch not in _MODELS:
        jcfg = jax_get_config(arch).reduced()
        pcfg = get_config(arch).reduced()
        jm, pm = jax_build_model(jcfg), build_model(pcfg, device="cpu")
        jp, pp = _pair(jm, pm, seed=11)
        # the norms' and biases' zeros and ones at init hide a mix-up: perturb them
        rs = np.random.RandomState(12)
        jp = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rs.randn(*a.shape).astype(np.float32)
                          if a.ndim in (1, 2) and a.shape[-1] == jcfg.d_model
                          and a.shape[0] != jcfg.vocab else np.asarray(a), jp)
        jp = jax.tree.map(jnp.asarray, jp)
        pp = params_from_numpy(pm, _np(jp), device="cpu")
        _MODELS[arch] = (jcfg, jm, jp, pm, pp)
    return _MODELS[arch]


def _inputs(cfg, n, t, seed):
    toks = np.random.RandomState(seed).randint(0, cfg.vocab, (n, t)).astype(np.int32)
    if cfg.frontend != "vision":
        return jnp.asarray(toks), _t(toks)
    prefix = _rand(seed + 1, n, cfg.n_prefix, cfg.d_model)
    return ({"tokens": jnp.asarray(toks), "prefix": jnp.asarray(prefix)},
            {"tokens": _t(toks), "prefix": _t(prefix)})


@pytest.mark.parametrize("arch", DENSE)
def test_reduced_dense_logits_match_jax(arch):
    cfg, jm, jp, pm, pp = _models(arch)
    jx, px = _inputs(cfg, 2, 12, 1)
    want = jm.apply(jp, jx)
    got = pm.call(pp, px)
    _close(got, want, LOGIT_TOL)
    _close(make_prefill_step(pm)(pp, px), np.asarray(want)[:, -1], LOGIT_TOL)
    assert isinstance(pm.mods[0], PrefixEmbed) == (cfg.frontend == "vision")
    assert type(pm.mods[-2]).__name__ == {"layernorm": "LayerNorm",
                                          "rmsnorm": "RMSNorm"}[cfg.norm]


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "gemma3-12b"])
def test_reduced_dense_serve_chain_matches_jax_across_ring_wrap(arch):
    cfg, jm, jp, pm, pp = _models(arch)
    n, steps, max_len = 2, 14, 16  # gemma3's window-8 layer's ring wraps at position 8
    toks = np.random.RandomState(2).randint(0, cfg.vocab, (n, steps)).astype(np.int32)
    jc = jm.init_serve_cache(jp, n, max_len, jnp.float32)
    pc = pm.init_serve_cache(pp, n, max_len, torch.float32)
    jstep = jax.jit(jm.serve_step)
    decode = make_decode_step(pm)
    full = pm.call(pp, _t(toks))
    for t in range(steps):
        jl, jc = jstep(jp, jc, jnp.asarray(toks[:, t]), jnp.asarray(t, jnp.int32))
        pl, pc = decode(pp, pc, _t(toks[:, t]), t)
        _close(pl, jl, LOGIT_TOL)
        _close(pl, full[:, t], LOGIT_TOL)
    for g, w in zip(tree_leaves(pc), jax.tree.leaves(jc), strict=True):
        _close(g, w, LOGIT_TOL)
    if cfg.window_segments:
        assert int(pc[0][0]["pos"].max()) == steps - 1 and pc[0][0]["pos"].shape == (8,)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "internvl2-2b"])
def test_reduced_dense_greedy_generate_matches_jax(arch):
    cfg, jm, jp, pm, pp = _models(arch)
    prompts = np.random.RandomState(3).randint(0, cfg.vocab, (3, 5)).astype(np.int32)
    want = np.asarray(jax_generate(jm, jp, jnp.asarray(prompts), JaxServeConfig(max_len=12)))
    got = generate(pm, pp, _t(prompts), ServeConfig(max_len=12))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", DENSE)
def test_full_dense_param_count_matches_jax(arch):
    jcfg, pcfg = jax_get_config(arch), get_config(arch)
    assert pcfg.param_count() == jcfg.param_count()


def test_gemma3_nested_stacks_layout_matches_jax():
    """gemma3's [(1024, 5), (None, 1)] × 8: a ScanStack of a Sequential of
    (a ScanStack of 5, a block), cut to 2 repeats of [(4, 2), (None, 1)]."""
    jcfg = dataclasses.replace(jax_get_config("gemma3-12b").reduced(), n_layers=6,
                               window_segments=[(4, 2), (None, 1)], pattern_repeat=2)
    pcfg = dataclasses.replace(get_config("gemma3-12b").reduced(), n_layers=6,
                               window_segments=[(4, 2), (None, 1)], pattern_repeat=2)
    jm, pm = jax_build_model(jcfg), build_model(pcfg, device="cpu")
    jp, pp = _pair(jm, pm, seed=5)
    assert type(pm.mods[1]).__name__ == "ScanStack"
    inner = pp[1][0]["wq"]["w"]  # the window-4 segment: [repeat, layers, d, d]
    assert inner.shape == np.asarray(jp[1][0]["wq"]["w"]).shape and tuple(inner.shape[:2]) == (2, 2)
    toks = np.random.RandomState(7).randint(0, jcfg.vocab, (2, 9)).astype(np.int32)
    _close(pm.call(pp, _t(toks)), jm.apply(jp, jnp.asarray(toks)), LOGIT_TOL)
    assert pcfg.param_count(pm) == jcfg.param_count(jm)


def test_serve_launcher_serves_a_dense_config_on_cpu():
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                           "stablelm-1.6b", "--device", "cpu", "--max-len", "16"],
                          env=env, cwd=root, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "generated (4, 16) tokens on cpu" in proc.stdout
    assert "(stablelm-1.6b, 2 layers, float32)" in proc.stdout
