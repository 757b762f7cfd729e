"""Generalized backprop engine — one forward pass, K extension sweeps.

``run(model, params, inputs, targets, loss, extensions, cfg, rng)`` returns
``Results(loss, grads, logits, ext)`` with ``ext[name]`` a tree mirroring the
params (per-module stats).

Sweep plan (decided from the requested extensions):

  first      cotangent sweep — batch gradient + all first-order stats +
             KFAC/KFLR A-factors.  Always runs.
  ggn_exact  exact loss-Hessian factor ``S`` (Eq. 15/18), in chunks of
             ``cfg.class_chunk`` columns when that is set.
  ggn_mc     Monte-Carlo factor ``S̃`` (Eq. 20).
  jac        raw-Jacobian sweep with identity cotangents (the NTK family);
             flat ``[N, C]`` outputs only.
  kfra       averaged ``Ḡ`` recursion (Eq. 24); chain models only.
  hess       exact Hessian diagonal with residual ± factors (Eq. 25/26);
             chain models only.

Port of the monolithic lane of ``src/repro/core/engine.py``.  ``run`` works
on the device its tensors lie on; with ``cfg.use_kernels`` the reductions of
CUDA tensors go through the Hopper kernels (:mod:`repro_torch.kernels.ops`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Union

import torch

from .extensions import (
    Extension,
    ExtensionConfig,
    FusedMask,
    FusedSecondMask,
    by_name,
    first_order_mask,
    second_order_mask,
    sweeps_needed,
)
from .module import Module
from .reducers import merge_stat_trees as _merge_stat_trees
from .tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """Static per-call sweep plan, decided once from the extension set.

    ``fused_mask`` / ``fused_second_mask`` are the fused kernels' extension
    masks; ``fused_active`` says whether the config routes through them.
    Rank-1 (R == 1) layers still take their closed forms.
    """

    names: frozenset
    sweeps: frozenset
    first_exts: tuple
    kron_exts: tuple
    fused_mask: FusedMask
    fused_active: bool
    fused_second_mask: FusedSecondMask = FusedSecondMask()

    def describe(self) -> str:
        passes = 1 + sum(s in self.sweeps
                         for s in ("ggn_exact", "ggn_mc", "jac", "kfra", "hess"))
        fused = [k for k in ("l2", "moment", "dot") if getattr(self.fused_mask, k)]
        lane = fused if self.fused_active and fused else None
        second = [k for k in ("diag", "kron", "trace")
                  if getattr(self.fused_second_mask, k)]
        structures = list(self.posterior_structures())
        return (f"sweeps={sorted(self.sweeps) or ['first']} "
                f"passes={passes} fused_first_order={lane} "
                f"fused_second_order={second or None} "
                f"fused_active={self.fused_active} "
                f"laplace={structures or None}")

    def posterior_structures(self) -> tuple:
        """Laplace posterior structures this plan's statistics could fit."""
        out = []
        if self.names & {"diag_ggn", "diag_ggn_mc"}:
            out.append("diag")
        if self.names & {"kflr", "kfac"}:
            out.append("kron")
        if out:
            out.append("last_layer")
        return tuple(out)

    def run(self, model, params, inputs, targets, loss,
            cfg: Optional[ExtensionConfig] = None, rng=None) -> "Results":
        """:func:`run` for this plan's extensions."""
        extensions = tuple(by_name(n) for n in sorted(self.names))
        return run(model, params, inputs, targets, loss,
                   extensions=extensions, cfg=cfg, rng=rng)


def plan_sweeps(extensions: Sequence[Extension],
                cfg: Optional[ExtensionConfig] = None) -> SweepPlan:
    """The static sweep plan for a set of requested extensions."""
    cfg = cfg or ExtensionConfig()
    first_exts = tuple(e for e in extensions if e.sweep == "first")
    return SweepPlan(
        names=frozenset(e.name for e in extensions),
        sweeps=frozenset(sweeps_needed(extensions)),
        first_exts=first_exts,
        kron_exts=tuple(e for e in extensions if e.name in ("kfac", "kflr")),
        fused_mask=first_order_mask(first_exts),
        fused_active=cfg.use_kernels and cfg.use_fused,
        fused_second_mask=second_order_mask(extensions),
    )


def plan_for_batch(extensions, cfg: Optional[ExtensionConfig], n: int, mesh=None,
                   shard_axes=("data",), microbatch_size: Optional[int] = None
                   ) -> SweepPlan:
    """The sweep lane for a batch of ``n`` samples: the single-device
    :class:`SweepPlan` of ``extensions``.

    The port has that one lane so far.  A ``mesh`` (the batch-sharded lane,
    ROADMAP queue A item 12) or a ``microbatch_size`` that cuts the batch
    into more than one slice (the accumulated lane, item 6) raises, rather
    than running another lane silently.
    """
    if mesh is not None:
        raise NotImplementedError(
            f"plan_for_batch: the sharded lane (mesh over {tuple(shard_axes)}) is "
            "not ported yet (ROADMAP queue A item 12)")
    if microbatch_size and -(-n // microbatch_size) > 1:
        raise NotImplementedError(
            f"plan_for_batch: microbatch_size={microbatch_size} cuts a batch of {n} "
            "into several slices; the accumulated lane is not ported yet "
            "(ROADMAP queue A item 6)")
    return plan_sweeps(extensions, cfg)


@dataclasses.dataclass
class Results:
    loss: torch.Tensor
    grads: Any
    logits: Any
    ext: Dict[str, Any]

    def __getitem__(self, k):
        return self.ext[k]


def _tree_add(a, b):
    if a is None:
        return b
    return tree_map(torch.add, a, b)


def _zip_stats(fn, st, gr):
    """Map fn over (stats, grads) in parallel, tolerating () stat holes."""
    if st is None or (isinstance(st, tuple) and len(st) == 0):
        return ()
    if isinstance(st, dict):
        return {k: _zip_stats(fn, v, gr.get(k) if isinstance(gr, dict) else None)
                for k, v in st.items()}
    if isinstance(st, (tuple, list)):
        gr_t = gr if isinstance(gr, (tuple, list)) else (None,) * len(st)
        return tuple(_zip_stats(fn, s, g) for s, g in zip(st, gr_t))
    return fn(st, gr)


MCDraws = Union[torch.Generator, torch.Tensor]


def _default_rng(sweeps, cfg, rng, device) -> Optional[MCDraws]:
    """The MC sweep's ``rng``: an explicit generator or draws win, else a
    generator on ``device`` seeded with ``cfg.mc_seed``, else an error when
    an MC extension needs draws."""
    if rng is not None or "ggn_mc" not in sweeps:
        return rng
    if cfg.mc_seed is None:
        raise ValueError(
            "MC extensions need an rng: pass rng= (a torch.Generator or the "
            "draws) or set ExtensionConfig(mc_seed=...)")
    return torch.Generator(device=device).manual_seed(cfg.mc_seed)


@torch.no_grad()
def run(
    model: Module,
    params,
    inputs,
    targets,
    loss,
    extensions: Sequence[Extension] = (),
    cfg: Optional[ExtensionConfig] = None,
    rng: Optional[MCDraws] = None,
) -> Results:
    """One generalized backward pass: batch gradient + K extensions.

    Parameters
    ----------
    model : Module
        A module tree (e.g. ``Sequential`` of layers).
    params
        Parameter tree, as ``model.params()`` or the weight bridge returns it
        (the JAX ``Sequential.init`` layout).
    inputs : Tensor
        Batch inputs, leading sample axis N.
    targets : Tensor
        Loss targets; ``CrossEntropyLoss`` masks positions with
        ``targets < 0``.
    loss
        ``CrossEntropyLoss`` or ``MSELoss``.
    extensions : sequence of Extension
        Quantities to extract, e.g. ``(BatchL2, Variance, KFAC)``.
    cfg : ExtensionConfig, optional
        Kernel routing, MC sample count/seed, class chunking.
    rng : torch.Generator or Tensor, optional
        The MC sweep's draws: a generator, or the draws themselves (see
        :mod:`repro_torch.core.loss_hessian`).  Optional when
        ``cfg.mc_seed`` is set: that seeds a generator on the inputs'
        device, so a CPU and a CUDA run with one seed draw differently;
        pass one generator or the draws to make them agree.

    Returns
    -------
    Results
        ``loss``, ``grads`` (params-shaped), ``logits`` and ``ext[name]``,
        one entry per requested extension mirroring the params.
    """
    cfg = cfg or ExtensionConfig()
    plan = plan_sweeps(extensions, cfg)
    sweeps = plan.sweeps
    first_exts, kron_exts = plan.first_exts, plan.kron_exts

    # ---- forward ----------------------------------------------------------
    z, tape = model.forward_tape(params, inputs)
    loss_val = loss.value(z, targets)

    # ---- first-order sweep -------------------------------------------------
    g = loss.grad(z, targets)
    _, grads, stats = model.backward(params, tape, g, first_exts + kron_exts, cfg)

    ext: Dict[str, Any] = {}
    names = plan.names
    for name in ("batch_grad", "batch_l2", "batch_dot"):
        if name in names:
            ext[name] = _merge_stat_trees(stats, name)
    if "second_moment" in names or "variance" in names:
        sum_g2 = _merge_stat_trees(stats, "_sum_grad2")
        n = tree_leaves(inputs)[0].shape[0]
        if "second_moment" in names:
            ext["second_moment"] = tree_map(lambda s: s * float(n), sum_g2)
        if "variance" in names:
            ext["variance"] = _zip_stats(
                lambda s, gr: s * float(n) - gr.float() ** 2, sum_g2, grads)
    kron_a = _merge_stat_trees(stats, "_kron_a") if kron_exts else None

    # ---- GGN sweeps ---------------------------------------------------------
    if "ggn_exact" in sweeps:
        exact_exts = tuple(e for e in extensions if e.sweep == "ggn_exact")
        C = loss.n_exact_cols(z)  # U·C columns for token-factored losses
        chunk = cfg.class_chunk or C
        if "ggn_gram" in names and chunk < C:
            # Cross-column Gram entries K[·,·,c,c'] pair columns across
            # chunks; one chunk only ever sees its own columns.
            raise ValueError(
                "GGNGram is incompatible with class_chunk: the logit-space "
                "Gram needs all C̃ columns of the sqrt-Hessian factor at "
                "once (cross-chunk column pairs are unformable)")
        curv = None
        for lo in range(0, C, chunk):
            S = loss.sqrt_hessian_chunk(z, targets, lo, min(chunk, C - lo))
            _, cv = model.curv_backward(params, tape, S, exact_exts, cfg, "exact")
            curv = _tree_add(curv, cv)
        if "diag_ggn" in names:
            ext["diag_ggn"] = _merge_stat_trees(curv, "diag_ggn")
        if "kflr" in names:
            ext["kflr"] = _combine_kron(curv, kron_a, "kflr")
        if "ggn_trace" in names:
            ext["ggn_trace"] = _merge_stat_trees(curv, "ggn_trace")
        if "ggn_gram" in names:
            ext["ggn_gram"] = _merge_stat_trees(curv, "ggn_gram")

    if "ggn_mc" in sweeps:
        mc_exts = tuple(e for e in extensions if e.sweep == "ggn_mc")
        draws = _default_rng(sweeps, cfg, rng, z.device)
        S = loss.sqrt_hessian_mc(draws, z, targets, cfg.mc_samples)
        _, curv = model.curv_backward(params, tape, S, mc_exts, cfg, "mc")
        if "diag_ggn_mc" in names:
            ext["diag_ggn_mc"] = _merge_stat_trees(curv, "diag_ggn_mc")
        if "kfac" in names:
            ext["kfac"] = _combine_kron(curv, kron_a, "kfac")

    # ---- raw-Jacobian sweep (empirical NTK family) --------------------------
    if "jac" in sweeps:
        jac_exts = tuple(e for e in extensions if e.sweep == "jac")
        if z.dim() != 2:
            raise ValueError(
                "NTK extensions need flat [N, C] model outputs, got logits "
                f"of shape {tuple(z.shape)} — reduce the sequence axis before "
                "the head or restrict the NTK to a flat-output model")
        C = z.shape[-1]
        # Identity cotangents per class, S0[c, n, :] = e_c: the transposed-
        # Jacobian sweep then yields raw per-sample Jacobian factors (no loss
        # curvature, no 1/M scaling, no MC draws).
        S0 = torch.eye(C, dtype=torch.float32, device=z.device)[:, None, :].expand(
            C, z.shape[0], C)
        _, jcurv = model.curv_backward(params, tape, S0, jac_exts, cfg, "ntk")
        if "ntk" in names:
            ext["ntk"] = _merge_stat_trees(jcurv, "ntk")
        if "ntk_classwise" in names:
            ext["ntk_classwise"] = _merge_stat_trees(jcurv, "ntk_classwise")

    # ---- chain-only sweeps ---------------------------------------------------
    if "kfra" in sweeps:
        Gbar = loss.hessian_mean(z, targets)
        _, kstats = model.kfra_backward(params, tape, Gbar, extensions, cfg)
        ext["kfra"] = _merge_stat_trees(kstats, "kfra")

    if "hess" in sweeps:
        S = loss.sqrt_hessian(z, targets)
        _, _, hstats = model.hess_backward(params, tape, g, [(S, 1.0)],
                                           extensions, cfg)
        ext["diag_hessian"] = _merge_stat_trees(hstats, "diag_hessian")

    return Results(loss=loss_val, grads=grads, logits=z, ext=ext)


def _combine_kron(curv_stats, kron_a_stats, name):
    """Zip B-factors (curvature sweep) with A-factors (first sweep)."""
    b_tree = _merge_stat_trees(curv_stats, name)

    def rec(b_node, a_node):
        if b_node is None:
            return None
        if isinstance(b_node, dict) and b_node and set(b_node) <= {"w", "b", "g"}:
            # module-level stats dict ({'w': {'B': ...}, 'b': ...})
            out = {}
            for k, v in b_node.items():
                entry = dict(v) if isinstance(v, dict) else {"B": v}
                if isinstance(a_node, dict) and k in a_node:
                    entry["A"] = a_node[k]
                out[k] = entry
            return out
        if isinstance(b_node, (tuple, list)):
            a_children = (a_node if isinstance(a_node, (tuple, list))
                          else (None,) * len(b_node))
            return tuple(rec(bc, ac) for bc, ac in zip(b_node, a_children))
        return b_node

    return rec(b_tree, kron_a_stats)


def _sum_leaves(ext_tree, what):
    leaves = tree_leaves(ext_tree)
    if not leaves:
        raise ValueError(f"empty {what} stats tree — was the extension run?")
    out = leaves[0].float()
    for leaf in leaves[1:]:
        out = out + leaf.float()
    return out


def ntk_total(ext_tree):
    """The empirical NTK Θ = J Jᵀ: the sum of ``run(...).ext['ntk']``'s
    per-parameter ``[N, N]`` blocks (``[N, N, C]`` for ``ntk_classwise``)."""
    return _sum_leaves(ext_tree, "NTK")


def gram_total(ext_tree):
    """The half-sandwich kernel K = J' J'ᵀ (J' = √Hᵀ J): the sum of
    ``run(...).ext['ggn_gram']``'s per-parameter ``[N, N, C̃, C̃]`` blocks,
    the ``[N·C̃]`` operator kernel-space natural gradients invert."""
    return _sum_leaves(ext_tree, "GGN-Gram")


def loss_and_grad(model, params, inputs, targets, loss):
    """Plain training objective — the baseline backward pass."""
    res = run(model, params, inputs, targets, loss, extensions=())
    return res.loss, res.grads
