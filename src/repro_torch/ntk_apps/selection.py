"""Active-learning / coreset subset selection off extracted NTK blocks.

* :func:`greedy_max_diversity`: sequential GP-variance maximization on the
  class-traced NTK ``[N, N]`` by an incremental pivoted Cholesky (O(N·k) a
  step); the marginal-variance pick is the greedy ``log det(K_SS + εI)``
  maximizer.
* :func:`bait_select`: BAIT-style Fisher selection (Ash et al. 2021) on the
  classwise Gram ``[N, N, C̃, C̃]``: greedily minimize ``tr((F_S + λI)⁻¹
  F_pool)``, which Woodbury turns into Gram space,

      tr((F_S + λI)⁻¹ F_pool) = (1/λ) [ tr(K) − tr((K_SS + λI)⁻¹ K_S,· K_·,Sᵀ) ]

  so each candidate costs a ``[|S|·C̃]``-sized solve on blocks of the
  extracted kernel; the candidates of a step are solved as one batch
  (``torch.linalg.solve`` on ``[candidates, |S|·C̃, |S|·C̃]``).

:func:`select_subset` extracts the kernel through the engine (``cross_dot``
on the card; in slices under ``microbatches=k``).  The greedy loops read
each pick on the host.  Port of ``src/repro/ntk_apps/selection.py``;
``mesh`` raises (ROADMAP queue A item 12).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import obs
from repro_torch.core.engine import gram_total, ntk_total, plan_sweeps, refuse_mesh
from repro_torch.core.extensions import NTK, ExtensionConfig, GGNGram
from repro_torch.core.loss_hessian import _f32
from repro_torch.core.tree import tree_leaves


class SelectionResult(NamedTuple):
    indices: torch.Tensor     # [k] selected pool indices, in pick order
    scores: torch.Tensor      # [k] greedy objective at each pick
    kernel: torch.Tensor      # the extracted kernel the selection ran on


def greedy_max_diversity(K, k: int, *, jitter: float = 1e-6):
    """Greedy max-variance (≡ max-logdet) selection on a PSD ``[N, N]``.

    Returns ``(indices [k], variances [k])``: ``variances[t]`` is the picked
    point's posterior variance given the first ``t`` picks; non-increasing.
    """
    K = _f32(torch.as_tensor(K))
    n = K.shape[0]
    if not 0 < k <= n:
        raise ValueError(f"greedy_max_diversity: k={k} outside 1..{n}")
    # d holds every candidate's residual (conditional) variance; each pick
    # appends the Cholesky column that downdates it
    d = torch.diagonal(K) + jitter
    C = torch.zeros((n, k), dtype=K.dtype, device=K.device)
    picked, gains = [], []
    for t in range(k):
        d_masked = d.clone()
        d_masked[picked] = -torch.inf
        i = int(torch.argmax(d_masked))
        v = d[i]
        col = K[:, i].clone()
        col[i] += jitter
        c = (col - C[:, :t] @ C[i, :t]) / torch.sqrt(v.clamp_min(1e-30))
        C[:, t] = c
        d = d - c * c
        picked.append(i)
        gains.append(v)
    return torch.tensor(picked, dtype=torch.int64, device=K.device), torch.stack(gains)


def _as_flat_gram(K):
    """``[N, N]`` or ``[N, N, C, C]`` → block-flattened ``[N·C, N·C]``."""
    K = _f32(torch.as_tensor(K))
    if K.dim() == 2:
        K = K[:, :, None, None]
    n, _, c, _ = K.shape
    return K.permute(0, 2, 1, 3).reshape(n * c, n * c), n, c


def bait_select(K, k: int, *, lam: float = 1e-3):
    """Greedy BAIT selection.  ``K``: ``[N, N]`` or classwise
    ``[N, N, C̃, C̃]`` (``gram_total`` of the ``ggn_gram`` extension).

    Returns ``(indices [k], objectives [k])``: ``objectives[t]`` is
    ``tr((F_S + λI)⁻¹ F_pool)`` after the ``t``-th pick (decreasing).
    """
    K2, n, c = _as_flat_gram(K)
    if not 0 < k <= n:
        raise ValueError(f"bait_select: k={k} outside 1..{n}")
    tr_pool = torch.trace(K2)
    block = torch.arange(c, device=K2.device)
    picked, objs = [], []
    for _ in range(k):
        cands = torch.tensor([j for j in range(n) if j not in picked], device=K2.device)
        base = (torch.cat([block + i * c for i in picked]) if picked
                else torch.zeros(0, dtype=torch.int64, device=K2.device))
        rows = torch.cat([base.expand(len(cands), -1), cands[:, None] * c + block], 1)
        # Woodbury: tr((F_S+λI)⁻¹F_pool) in Gram space (module docstring)
        Kss = K2[rows[:, :, None], rows[:, None, :]]              # [B, m, m]
        Ksp = K2[rows]                                            # [B, m, N·C]
        eye = torch.eye(rows.shape[1], dtype=K2.dtype, device=K2.device)
        inner = torch.linalg.solve(Kss + lam * eye, Ksp @ Ksp.transpose(1, 2))
        vals = (tr_pool - torch.diagonal(inner, dim1=1, dim2=2).sum(-1)) / lam
        a = int(torch.argmin(vals))
        picked.append(int(cands[a]))
        objs.append(vals[a])
    return (torch.tensor(picked, dtype=torch.int64, device=K2.device),
            torch.stack(objs))


def select_subset(model, params, inputs, targets, loss, k: int, *,
                  method: str = "diversity", lam: float = 1e-3, jitter: float = 1e-6,
                  cfg=None, mesh=None, shard_axes=("data",),
                  microbatches: Optional[int] = None, rng=None) -> SelectionResult:
    """Pick ``k`` of the pool: ``method='diversity'`` on the class-traced NTK,
    ``'bait'`` on the loss-scaled classwise Gram (``ggn_gram``, the Fisher
    blocks of the canonical losses).  ``microbatches=k`` extracts the kernel
    in row blocks."""
    if method not in ("diversity", "bait"):
        raise ValueError(f"select_subset: unknown method {method!r} "
                         "(want 'diversity' or 'bait')")
    refuse_mesh("select_subset", mesh, shard_axes)
    cfg = cfg or ExtensionConfig()
    plan = plan_sweeps((NTK if method == "diversity" else GGNGram,), cfg)
    if microbatches and microbatches > 1:
        plan = plan.accumulate(microbatches)
    n = tree_leaves(inputs)[0].shape[0]
    with obs.span("ntk_apps/select_subset", method=method, n=n, k=k, sharded=False,
                  microbatches=microbatches or 1):
        res = plan.run(model, params, inputs, targets, loss, cfg=cfg, rng=rng)
        if method == "diversity":
            K = ntk_total(res.ext["ntk"])
            idx, scores = greedy_max_diversity(K, k, jitter=jitter)
        else:
            K = gram_total(res.ext["ggn_gram"])
            idx, scores = bait_select(K, k, lam=lam)
    return SelectionResult(indices=idx, scores=scores, kernel=K)
