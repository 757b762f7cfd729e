"""The port's language-model serving path on the CPU, against the JAX package.

The same numpy inputs (made from a seed) and the same parameters (JAX's
``init``, copied across with ``repro_torch.bridge.params_from_numpy``) go
through the JAX function and the port's:

* the mixing functions: ``apply_rope``, ``sdpa`` (GQA g ∈ {1, 2}, windows,
  explicit positions with empty ring slots, head widths 16 to 240 with dv ≠
  dh), ``cache_update``,
  ``wkv_chunked`` (T not a multiple of the chunk, u and state0 given or not,
  per-channel and scalar decay) and ``wkv_step``;
* the plain versions of the two kernels, ``ref.flash_attention`` and
  ``ref.wkv``, against ``sdpa`` and ``wkv_chunked`` (the Pallas kernels fail
  on the installed JAX: ``pallas.load``);
* the modules: ``Embedding``, ``RMSNorm``, ``Param``, ``ScanStack``,
  ``AttnBlock`` and ``HymbaBlock`` (``call`` and ``decode_step``);
* ``hymba_1_5b.reduced()`` end to end: logits, the ``serve_step`` chain across
  a wrap of the window-8 ring, ``make_prefill_step``, greedy ``generate``.

Tolerances (float32, sums in another order): 3e-5 for attention and RoPE,
3e-4 for WKV (the chunked algebra multiplies exp(±P) factors), as
``tests/test_kernels.py`` holds the Pallas kernels; 1e-4 for model logits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import module as jmod
from repro.nn import blocks as jblocks
from repro.nn import functional as JF
from repro.nn import layers as jlayers
from repro.nn.models import build_model as jax_build_model
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import generate as jax_generate
from repro.train.step import make_prefill_step as jax_make_prefill_step
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config
from repro_torch.core import module as pmod
from repro_torch.core.tree import tree_leaves
from repro_torch.kernels import ref
from repro_torch.nn import blocks as pblocks
from repro_torch.nn import functional as PF
from repro_torch.nn import layers as players
from repro_torch.nn.models import build_model
from repro_torch.serve.engine import ServeConfig, generate
from repro_torch.train import make_decode_step, make_prefill_step

ATTN_TOL = 3e-5
WKV_TOL = 3e-4
LOGIT_TOL = 1e-4


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(port, want, tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(want), rtol=tol, atol=tol)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the mixing functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("positions", ["arange", "scalar"])
def test_apply_rope_matches_jax(positions):
    x = _rand(0, 2, 5, 3, 16)
    pos = np.arange(5) + 3 if positions == "arange" else 11
    want = JF.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500.0)
    got = PF.apply_rope(_t(x), torch.as_tensor(pos), 500.0)
    _close(got, want, ATTN_TOL)


SDPA_CASES = {
    "g1_causal": dict(t=9, s=9, kv=3, g=1),
    "g2_causal": dict(t=9, s=9, kv=2, g=2),
    "g2_window": dict(t=11, s=11, kv=2, g=2, window=4),
    "g1_noncausal": dict(t=7, s=12, kv=3, g=1, causal=False),
    "g2_ring": dict(t=1, s=8, kv=2, g=2, window=8, ring=True),
    "g2_positions": dict(t=4, s=10, kv=2, g=2, window=6, positions=True),
    "g1_all_masked": dict(t=2, s=6, kv=3, g=1, all_masked=True),
    # the head widths of the configs (h2o-danube3 120, codeqwen1.5 and
    # internvl2 128 in decode, deepseek-v2-lite's MLA 192 / 128, gemma3 240)
    "dh120_window": dict(t=11, s=11, kv=2, g=2, window=4, dh=120),
    "dh128_ring": dict(t=1, s=8, kv=2, g=2, window=8, ring=True, dh=128),
    "dh192_dv128": dict(t=9, s=9, kv=2, g=1, dh=192, dv=128),
    "dh240_gqa": dict(t=9, s=9, kv=1, g=2, dh=240),
    # h2o-danube3's dh 120 at g = 4 with a window, T·g = 72 ≥ 64 rows a KV
    # head: the shape the card gives the "wgmma" design
    "dh120_g4_window": dict(t=18, s=18, kv=2, g=4, window=7, dh=120),
}


def _sdpa_inputs(case):
    c = SDPA_CASES[case]
    n, dh = 2, c.get("dh", 16)
    q = _rand(1, n, c["t"], c["kv"] * c["g"], dh)
    k, v = _rand(2, n, c["s"], c["kv"], dh), _rand(3, n, c["s"], c["kv"], c.get("dv", dh))
    kw = dict(causal=c.get("causal", True), window=c.get("window"))
    if c.get("ring"):  # a ring of 8 at position 13: it wrapped at 8, slots 6, 7 hold 6, 7
        kw["q_positions"] = np.array([13], np.int32)
        kw["k_positions"] = np.array([8, 9, 10, 11, 12, 13, 6, 7], np.int32)
    if c.get("positions"):
        kw["q_positions"] = np.array([5, 6, 7, 8], np.int32)
        kw["k_positions"] = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, -1], np.int32)
    if c.get("all_masked"):  # no slot written: every logit is masked
        kw["q_positions"] = np.array([3, 4], np.int32)
        kw["k_positions"] = np.full((c["s"],), -1, np.int32)
    return q, k, v, kw


def _port_kw(kw):
    return {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}


def _jax_kw(kw):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}


@pytest.mark.parametrize("case", sorted(SDPA_CASES))
def test_sdpa_matches_jax(case):
    q, k, v, kw = _sdpa_inputs(case)
    want = JF.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **_jax_kw(kw))
    got = PF.sdpa(_t(q), _t(k), _t(v), **_port_kw(kw))
    _close(got, want, ATTN_TOL)


@pytest.mark.parametrize("case", sorted(SDPA_CASES))
def test_plain_flash_attention_matches_jax_sdpa(case):
    q, k, v, kw = _sdpa_inputs(case)
    want = JF.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **_jax_kw(kw))
    got = ref.flash_attention(_t(q), _t(k), _t(v), **_port_kw(kw))
    _close(got, want, ATTN_TOL)
    if case == "g1_all_masked":  # the uniform average of all S values
        _close(got, np.repeat(v.mean(1, keepdims=True), 2, axis=1), ATTN_TOL)


@pytest.mark.parametrize("ring", [True, False])
def test_cache_update_matches_jax(ring):
    ck, cv = _rand(0, 2, 4, 2, 8), _rand(1, 2, 4, 2, 8)
    pbuf = np.array([4, 5, -1, 3], np.int32)
    kn, vn = _rand(2, 2, 1, 2, 8), _rand(3, 2, 1, 2, 8)
    for pos in (6, 2):
        want = JF.cache_update(jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pbuf),
                               jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos, jnp.int32),
                               jnp.asarray(ring))
        got = PF.cache_update(_t(ck), _t(cv), _t(pbuf), _t(kn), _t(vn),
                              torch.tensor(pos, dtype=torch.int32), ring)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


WKV_CASES = {  # (T, chunk, dk, dv, per-channel decay, u, state0)
    "ssd_scalar_decay": (32, 16, 8, 16, False, False, True),
    "rwkv_u": (32, 16, 8, 8, True, True, False),
    "ragged_t20": (20, 16, 8, 16, True, True, True),
    "prime_t13": (13, 16, 4, 8, False, False, False),
    "decode_t1": (1, 16, 8, 16, False, False, True),
}


def _wkv_inputs(case):
    t, chunk, dk, dv, per_channel, has_u, has_s0 = WKV_CASES[case]
    n, h = 2, 3
    r, k = _rand(4, n, t, h, dk), _rand(5, n, t, h, dk)
    v = _rand(6, n, t, h, dv)
    lw = -np.log1p(np.exp(_rand(7, n, t, h, dk if per_channel else 1)))  # −softplus
    u = _rand(8, h, dk) if has_u else None
    s0 = _rand(9, n, h, dk, dv) if has_s0 else None
    return r, k, v, lw.astype(np.float32), u, s0, chunk


def _jax_wkv(r, k, v, lw, u, s0, chunk):
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    return JF.wkv_chunked(j(r), j(k), j(v), j(lw), u=j(u), state0=j(s0), chunk=chunk)


@pytest.mark.parametrize("case", sorted(WKV_CASES))
def test_wkv_chunked_matches_jax(case):
    r, k, v, lw, u, s0, chunk = _wkv_inputs(case)
    y_want, s_want = _jax_wkv(r, k, v, lw, u, s0, chunk)
    p = lambda a: None if a is None else _t(a)  # noqa: E731
    y, s = PF.wkv_chunked(_t(r), _t(k), _t(v), _t(lw), u=p(u), state0=p(s0), chunk=chunk)
    _close(y, y_want, WKV_TOL)
    _close(s, s_want, WKV_TOL)


@pytest.mark.parametrize("case", sorted(WKV_CASES))
def test_plain_wkv_matches_jax_wkv_chunked(case):
    r, k, v, lw, u, s0, chunk = _wkv_inputs(case)
    y_want, s_want = _jax_wkv(r, k, v, lw, u, s0, chunk)
    p = lambda a: None if a is None else _t(a)  # noqa: E731
    y, s = ref.wkv(_t(r), _t(k), _t(v), _t(lw), p(u), p(s0), PF.wkv_chunk(r.shape[1], chunk))
    _close(y, y_want, WKV_TOL)
    _close(s, s_want, WKV_TOL)


@pytest.mark.parametrize("with_u", [True, False])
def test_wkv_step_matches_jax(with_u):
    n, h, dk, dv = 2, 3, 8, 16
    r, k, v = _rand(0, n, h, dk), _rand(1, n, h, dk), _rand(2, n, h, dv)
    lw = -np.abs(_rand(3, n, h, dk))
    u = _rand(4, h, dk) if with_u else None
    S = _rand(5, n, h, dk, dv)
    want = JF.wkv_step(*(jnp.asarray(a) for a in (r, k, v, lw)),
                       None if u is None else jnp.asarray(u), jnp.asarray(S))
    got = PF.wkv_step(_t(r), _t(k), _t(v), _t(lw), None if u is None else _t(u), _t(S))
    for g, w in zip(got, want):
        _close(g, w, WKV_TOL)


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------


def _pair(jax_module, port_module, seed=0):
    """JAX's init copied into the port's module; (jax params, port params)."""
    jp = jax_module.init(jax.random.PRNGKey(seed))
    return jp, params_from_numpy(port_module, _np(jp), device="cpu")


def test_embedding_rmsnorm_param_match_jax():
    emb_j, emb_p = jmod.Embedding(11, 8), pmod.Embedding(11, 8, device="cpu")
    jp, pp = _pair(emb_j, emb_p)
    toks = np.array([[1, 10, 3], [0, 0, 7]], np.int32)
    _close(emb_p.call(pp, _t(toks)), emb_j.apply(jp, jnp.asarray(toks)), 0)
    assert np.isclose(emb_p.scale, emb_j.scale)
    norm_j, norm_p = jmod.RMSNorm(8), pmod.RMSNorm(8, device="cpu")
    jp = {"g": jnp.asarray(_rand(1, 8))}
    pp = params_from_numpy(norm_p, _np(jp), device="cpu")
    x = _rand(2, 2, 3, 8)
    _close(norm_p.call(pp, _t(x)), norm_j.apply(jp, jnp.asarray(x)), ATTN_TOL)
    par_j = jlayers.Param((5,), init=0.5)
    par_p = players.Param((5,), init=0.5, device="cpu")
    jp, pp = _pair(par_j, par_p)
    _close(par_p.call(pp, None), par_j.apply(jp, None), 0)


def _hymba_pair(window, dtype_j=jnp.float32):
    kw = dict(head_dim=8, ssm_state=4, window=window)
    jb = jblocks.HymbaBlock(32, 4, 2, 48, dtype=dtype_j, **kw)
    pb = pblocks.HymbaBlock(32, 4, 2, 48, device="cpu", **kw)
    return jb, pb


def _attn_pair(window):
    kw = dict(head_dim=8, window=window)
    return jblocks.AttnBlock(32, 4, 2, 48, **kw), pblocks.AttnBlock(32, 4, 2, 48,
                                                                    device="cpu", **kw)


def _decode_chain(block, params, x, n_steps, max_len, jax_side):
    """decode_step over positions 0..n_steps-1 of x [N, T, d]: outputs [N, T, d]."""
    n = x.shape[0]
    if jax_side:
        cache = block.init_cache(params, n, max_len, jnp.float32)
        step = jax.jit(lambda p, xp, c: block.decode_step(p, xp, c))
        outs = []
        for t in range(n_steps):
            (y, _), cache = step(params, (x[:, t:t + 1], jnp.asarray(t, jnp.int32)), cache)
            outs.append(np.asarray(y))
        return np.concatenate(outs, 1)
    cache = block.init_cache(params, n, max_len, torch.float32)
    outs = []
    for t in range(n_steps):
        (y, _), cache = block.decode_step(params, (x[:, t:t + 1], torch.tensor(t)), cache)
        outs.append(y.numpy())
    return np.concatenate(outs, 1)


@pytest.mark.parametrize("window", [None, 4], ids=["global", "window4"])
@pytest.mark.parametrize("kind", ["attn", "hymba"])
def test_block_call_and_decode_match_jax(kind, window):
    jb, pb = (_hymba_pair if kind == "hymba" else _attn_pair)(window)
    jp, pp = _pair(jb, pb, seed=3)
    x = _rand(4, 2, 10, 32)
    want = jb.apply(jp, jnp.asarray(x))
    _close(pb.call(pp, _t(x)), want, LOGIT_TOL)
    # decode past the window of 4 (the ring wraps) with max_len 10
    dec_j = _decode_chain(jb, jp, jnp.asarray(x), 10, 10, True)
    dec_p = _decode_chain(pb, pp, _t(x), 10, 10, False)
    _close(dec_p, dec_j, LOGIT_TOL)
    _close(dec_p, want, LOGIT_TOL)  # decode agrees with the full forward


def _stacked_cfg():
    """The reduced Hymba with a segment of two window layers: a ScanStack."""
    cfg = jax_get_config("hymba-1.5b").reduced()
    return dataclasses.replace(cfg, n_layers=3, window_segments=[(8, 2), (None, 1)])


def test_scanstack_layout_and_forward_match_jax():
    jcfg = _stacked_cfg()
    pcfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), n_layers=3,
                               window_segments=[(8, 2), (None, 1)])
    jm, pm = jax_build_model(jcfg), build_model(pcfg, device="cpu")
    jp, pp = _pair(jm, pm, seed=5)
    stack_j, stack_p = jp[1][0], pp[1][0]
    assert stack_p["wq"]["w"].shape == np.asarray(stack_j["wq"]["w"]).shape == (2, 64, 64)
    x = _rand(6, 2, 6, 64)
    want = jm.mods[1].mods[0].apply(stack_j, jnp.asarray(x))
    _close(pm.mods[1].mods[0].call(stack_p, _t(x)), want, LOGIT_TOL)
    toks = np.random.RandomState(7).randint(0, jcfg.vocab, (2, 12)).astype(np.int32)
    _close(pm.call(pp, _t(toks)), jm.apply(jp, jnp.asarray(toks)), LOGIT_TOL)
    assert pcfg.param_count(pm) == jcfg.param_count(jm)


def test_full_hymba_param_count_matches_jax():
    jcfg, pcfg = jax_get_config("hymba-1.5b"), get_config("hymba-1.5b")
    assert pcfg.param_count() == jcfg.param_count() == 1268793600


# ---------------------------------------------------------------------------
# hymba_1_5b.reduced() end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hymba():
    jcfg = jax_get_config("hymba-1.5b").reduced()
    pcfg = get_config("hymba-1.5b").reduced()
    jm, pm = jax_build_model(jcfg), build_model(pcfg, device="cpu")
    jp, pp = _pair(jm, pm, seed=11)
    return jcfg, jm, jp, pm, pp


def test_reduced_hymba_logits_match_jax(hymba):
    cfg, jm, jp, pm, pp = hymba
    toks = np.random.RandomState(1).randint(0, cfg.vocab, (2, 20)).astype(np.int32)
    want = jm.apply(jp, jnp.asarray(toks))
    _close(pm.call(pp, _t(toks)), want, LOGIT_TOL)
    last = make_prefill_step(pm)(pp, _t(toks))
    _close(last, jax_make_prefill_step(jm)(jp, jnp.asarray(toks)), LOGIT_TOL)


def test_reduced_hymba_serve_chain_matches_jax_across_ring_wrap(hymba):
    cfg, jm, jp, pm, pp = hymba
    n, steps, max_len = 2, 14, 16  # the window-8 layer's ring wraps at position 8
    toks = np.random.RandomState(2).randint(0, cfg.vocab, (n, steps)).astype(np.int32)
    jc = jm.init_serve_cache(jp, n, max_len, jnp.float32)
    pc = pm.init_serve_cache(pp, n, max_len, torch.float32)
    jstep = jax.jit(jm.serve_step)
    decode = make_decode_step(pm)
    full = jm.apply(jp, jnp.asarray(toks))
    for t in range(steps):
        jl, jc = jstep(jp, jc, jnp.asarray(toks[:, t]), jnp.asarray(t, jnp.int32))
        pl, pc = decode(pp, pc, _t(toks[:, t]), t)
        _close(pl, jl, LOGIT_TOL)
        _close(pl, full[:, t], LOGIT_TOL)
    for g, w in zip(tree_leaves(pc), jax.tree.leaves(jc)):
        _close(g, w, LOGIT_TOL)


def test_reduced_hymba_greedy_generate_matches_jax(hymba):
    cfg, jm, jp, pm, pp = hymba
    prompts = np.random.RandomState(3).randint(0, cfg.vocab, (3, 5)).astype(np.int32)
    want = np.asarray(jax_generate(jm, jp, jnp.asarray(prompts), JaxServeConfig(max_len=14)))
    got = generate(pm, pp, _t(prompts), ServeConfig(max_len=14))
    np.testing.assert_array_equal(got.numpy(), want)
    # the logits after the last generated token, both ways
    _close(make_prefill_step(pm)(pp, got), jax_make_prefill_step(jm)(jp, jnp.asarray(want)),
           LOGIT_TOL)


def test_generate_with_temperature_and_eos(hymba):
    cfg, _, _, pm, pp = hymba
    prompts = torch.randint(0, cfg.vocab, (3, 4), generator=torch.Generator().manual_seed(0))
    sc = ServeConfig(max_len=12, temperature=0.7)
    a = generate(pm, pp, prompts, sc, rng=torch.Generator().manual_seed(5))
    b = generate(pm, pp, prompts, sc, rng=torch.Generator().manual_seed(5))
    assert a.shape == (3, 12) and a.dtype == torch.int32 and torch.equal(a, b)
    assert torch.equal(a[:, :4], prompts.to(torch.int32))
    greedy = generate(pm, pp, prompts, ServeConfig(max_len=12))
    eos = int(greedy[0, 4])  # the first generated token of row 0 ends it
    stopped = generate(pm, pp, prompts, ServeConfig(max_len=12, eos_id=eos))
    assert stopped[0, 4] == eos and (stopped[0, 5:] == 0).all()


def test_bf16_weights_cross_bit_equal():
    jcfg = dataclasses.replace(jax_get_config("hymba-1.5b").reduced(), dtype="bfloat16")
    pcfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), dtype="bfloat16")
    jm, pm = jax_build_model(jcfg), build_model(pcfg, device="cpu")
    jp, pp = _pair(jm, pm, seed=13)
    leaves_j = jax.tree.leaves(jp)
    assert {str(a.dtype) for a in leaves_j} == {"bfloat16", "float32"}  # a_log is float32
    for got, want in zip(tree_leaves(pp), leaves_j):
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    for got, want in zip(tree_leaves(params_to_numpy(pp)), leaves_j):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    toks = torch.randint(0, pcfg.vocab, (2, 6), generator=torch.Generator().manual_seed(1))
    logits = pm.call(pp, toks)
    assert logits.dtype == torch.bfloat16 and torch.isfinite(logits.float()).all()


def test_other_kinds_name_their_roadmap_item():
    """Both mixtures of experts build, MLA (DeepSeek-V2) and GQA (Granite),
    their active parameters counted as JAX counts them: no kind of the JAX
    package is left to port."""
    for arch in ("deepseek-v2-lite-16b", "granite-moe-1b-a400m"):
        cfg = get_config(arch).reduced()
        model = build_model(cfg, device="cpu")
        assert cfg.active_param_count(model) == jax_get_config(
            arch).reduced().active_param_count(), arch
