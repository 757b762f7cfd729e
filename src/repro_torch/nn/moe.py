"""Capacity-based top-k mixture-of-experts dispatch (GShard-style).

Port of ``src/repro/nn/moe.py``.  Tokens are routed to ``[E, capacity]``
slots by a scatter (no [M, E, C] one-hots); the experts' FFNs are
``BatchedDense`` products over those slots.  Gradients reach the router
through the combine weights; tokens past an expert's capacity are dropped
(standard capacity semantics), so an expert sees at most ``capacity`` of
them.  Per-expert BackPACK statistics (token-level moments, per-expert KFAC
factors) come from ``BatchedDense``'s formulas through the ``Wired`` graph.

Four places where a plain translation of JAX's code goes wrong:

* ``capacity`` keeps JAX's ``int(x + 0.999)``: ``math.ceil`` differs when
  the fraction is below 0.001.
* ``jax.lax.top_k`` puts the lower index first among equal values;
  ``torch.topk`` does not say which comes first.  A stable descending sort
  does what JAX does.  Ties are common once the router's logits are
  bfloat16, and a tie also moves each token's place in its expert, and so
  which tokens overflow.
* A token's place in its expert counts the (token, slot) pairs before it in
  token-major, slot-minor order: an integer cumsum of the one-hot experts.
* JAX drops an overflowed token by scattering out of bounds; here a mask
  zeroes its row before the scatter and its expert output after the gather.
  The gates are cast to the activations' dtype before the weighted sum, as
  in JAX.
"""
from __future__ import annotations

import torch


def capacity(n_tokens, n_experts, top_k, factor):
    """Slots an expert for ``n_tokens`` tokens routed ``top_k`` ways: JAX's
    ``max(int(n·k·factor / E + 0.999), 4)``."""
    return max(int(n_tokens * top_k * factor / n_experts + 0.999), 4)


def route(logits, top_k):
    """logits [M, E] → (gates [M, k] float32, idx [M, k], pos [M, k] int32,
    probs [M, E] float32).  ``pos`` is each (token, slot) pair's place in
    its expert's queue."""
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    gates = vals / (vals.sum(-1, keepdim=True) + 1e-9)
    m, e = probs.shape
    flat = idx.reshape(1, m * top_k)
    # [E, M·k]: the scan runs along the contiguous axis; down the M·k rows of
    # [M·k, E] the card's scan kernel took most of a prefill
    oh = torch.nn.functional.one_hot(flat[0], e).t().contiguous()
    before = torch.cumsum(oh, dim=1) - oh
    pos = before.gather(0, flat).reshape(m, top_k).to(torch.int32)
    return gates, idx, pos, probs


def moe_apply(call, h, logits, E, top_k, cap_factor, act):
    """h [N, T, d], logits [N, T, E] → [N, T, d].  ``call`` applies the
    ``Wired`` children ``e_gate``, ``e_up`` and ``e_down`` (each ``[E, cap,
    ·]`` → ``[E, cap, ·]``)."""
    n, t, d = h.shape
    m = n * t
    cap = capacity(m, E, top_k, cap_factor)
    hf = h.reshape(m, d)
    gates, idx, pos, _ = route(logits.reshape(m, E), top_k)
    keep = (pos < cap).reshape(-1, 1)
    # a dropped pair adds a zero row to the last slot of its expert
    slot = idx.reshape(-1) * cap + torch.clamp(pos, max=cap - 1).reshape(-1).long()
    rows = hf.repeat_interleave(top_k, dim=0)
    rows = torch.where(keep, rows, torch.zeros((), dtype=h.dtype, device=h.device))
    xe = torch.zeros((E * cap, d), dtype=h.dtype, device=h.device).index_add(0, slot, rows)
    xe = xe.reshape(E, cap, d)
    ye = call("e_down", act(call("e_gate", xe)) * call("e_up", xe))
    got = ye.reshape(E * cap, -1).index_select(0, slot) * keep.to(ye.dtype)
    y = (got.reshape(m, top_k, -1) * gates[..., None].to(got.dtype)).sum(1)
    return y.reshape(n, t, -1)


def dropped(logits, top_k, cap_factor):
    """The (token, slot) pairs ``moe_apply`` drops for router logits [N, T,
    E]: those whose place in their expert is past its capacity."""
    m, e = logits.shape[0] * logits.shape[1], logits.shape[-1]
    _, _, pos, _ = route(logits.reshape(m, e), top_k)
    return int((pos >= capacity(m, e, top_k, cap_factor)).sum())
