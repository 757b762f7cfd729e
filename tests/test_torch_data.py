"""The synthetic data pipeline: the port against the JAX package.

JAX's threefry stream cannot be reproduced in torch, so the tokens differ;
everything else is held against JAX's ``batch_for`` on the same configs
(reduced dense StableLM-2, the VLM InternVL2 with its prefix, the
encoder-decoder Whisper): the tree of the batch, each leaf's shape and
dtype, the −1 label positions.  Then the construction: labels are the inputs
shifted by one; with probability 0.7 the first label is the first input plus
``step % 17 + 1`` (mod V), on both sides within 0.05 of 0.7 on 4000 rows;
and a batch is a pure function of (seed, step, host), on the CPU and the
device it is asked for (the card by default, which raises without one).
"""
import dataclasses

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_get_config
from repro.data import synthetic as jsyn
from repro_torch.configs import SHAPES, get_config
from repro_torch.data import synthetic as syn

ARCHS = ["stablelm-1.6b", "internvl2-2b", "whisper-tiny"]


def _shape(seq, batch):
    return dataclasses.replace(SHAPES["train_4k"], seq_len=seq, global_batch=batch)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree) for p, v in _leaves(tree[k], f"{path}/{k}").items()}
    return {path: tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_for_matches_jax_layout(arch):
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    shape = _shape(16, 4)
    got = _leaves(syn.batch_for(cfg, shape, 3, seed=1, device="cpu"))
    want = _leaves(jsyn.batch_for(jcfg, dataclasses.replace(JSHAPES["train_4k"], seq_len=16,
                                                            global_batch=4), 3, seed=1))
    assert set(got) == set(want)
    for path, w in want.items():
        w = np.asarray(w)
        g = got[path]
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path
        if path == "/labels":
            np.testing.assert_array_equal(g.numpy() == -1, w == -1)
        if g.dtype == torch.int32:
            assert 0 <= int(g.min()) and int(g.max()) < cfg.vocab or path == "/labels"


@pytest.mark.parametrize("arch", ARCHS)
def test_labels_are_the_inputs_shifted(arch):
    cfg = get_config(arch).reduced()
    b = syn.batch_for(cfg, _shape(16, 4), 5, device="cpu")
    toks = b["inputs"]["tokens"] if isinstance(b["inputs"], dict) else b["inputs"]
    labels = b["labels"][:, -toks.shape[1]:]
    assert torch.equal(toks[:, 1:], labels[:, :-1])
    if cfg.frontend == "vision":
        assert (b["labels"][:, :cfg.n_prefix] == -1).all()
        assert b["inputs"]["prefix"].shape == (4, cfg.n_prefix, cfg.d_model)
        assert 0.015 < b["inputs"]["prefix"].float().std().item() < 0.025  # 0.02·N(0, 1)


@pytest.mark.parametrize("step", [0, 16, 40])
def test_structured_share(step):
    """The first label is the first input + offset w.p. 0.7 (a fresh uniform
    token otherwise): the port and JAX both within 0.05 of 0.7."""
    v, n = 97, 4000
    offset = step % 17 + 1
    dc = syn.DataConfig(vocab=v, seq_len=2, global_batch=n)
    b = syn.lm_batch(dc, step, device="cpu")
    share = ((b["inputs"][:, 0] + offset) % v == b["labels"][:, 0]).float().mean().item()
    jb = jsyn.lm_batch(jsyn.DataConfig(vocab=v, seq_len=2, global_batch=n), step)
    jshare = float(np.mean((np.asarray(jb["inputs"])[:, 0] + offset) % v
                           == np.asarray(jb["labels"])[:, 0]))
    assert abs(share - 0.7) < 0.05 and abs(jshare - 0.7) < 0.05
    # the rest of the row: the same mixture (0.7 · 0.3 + 1/V) on both sides
    rest = ((b["inputs"][:, 1] + offset) % v == b["labels"][:, 1]).float().mean().item()
    jrest = float(np.mean((np.asarray(jb["inputs"])[:, 1] + offset) % v
                          == np.asarray(jb["labels"])[:, 1]))
    assert abs(rest - jrest) < 0.05


def test_a_batch_is_a_function_of_seed_step_host():
    dc = syn.DataConfig(vocab=97, seq_len=8, global_batch=4, n_hosts=2)
    a = syn.lm_batch(dc, 7, device="cpu")
    assert torch.equal(a["inputs"], syn.lm_batch(dc, 7, device="cpu")["inputs"])
    assert a["inputs"].shape == (2, 8)
    for other in (dataclasses.replace(dc, seed=1), dataclasses.replace(dc, host_id=1)):
        assert not torch.equal(a["inputs"], syn.lm_batch(other, 7, device="cpu")["inputs"])
    assert not torch.equal(a["inputs"], syn.lm_batch(dc, 8, device="cpu")["inputs"])
    cfg = get_config("internvl2-2b").reduced()
    x = syn.batch_for(cfg, _shape(16, 4), 2, seed=3, device="cpu")
    y = syn.batch_for(cfg, _shape(16, 4), 2, seed=3, device="cpu")
    assert torch.equal(x["inputs"]["prefix"], y["inputs"]["prefix"])


def test_batch_for_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        syn.batch_for(get_config("stablelm-1.6b").reduced(), _shape(8, 2), 0)
