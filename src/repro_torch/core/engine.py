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

The accumulated lane (``SweepPlan.accumulate(k)``) runs the same sweep once
per slice of the batch and folds the results through each extension's
:class:`~repro_torch.core.reducers.Reducer`: batches beyond device memory.
It is one stepwise driver, :class:`SweepStream`, whose state between any two
work units is a tree of tensors that a checkpointer can save and restore
(``run_checkpointed`` / ``resume``).

Port of ``src/repro/core/engine.py`` (the monolithic and the single-device
accumulated lanes; the batch-sharded lane is ROADMAP queue A item 12).
``run`` works on the device its tensors lie on; with ``cfg.use_kernels`` the
reductions of CUDA tensors go through the Hopper kernels
(:mod:`repro_torch.kernels.ops`).

The :mod:`repro_torch.obs` spans are JAX's: ``engine/sweep`` around
``SweepPlan.run`` (``lane="monolithic"``) and ``AccumulatedSweepPlan.run``
(``lane="accumulated"``, with an ``engine/finalize`` child per carried
extension); a :class:`SweepStream` driven unit by unit (``stream``,
``run_checkpointed``, ``resume``) records ``engine/stream/slice`` and
``engine/stream/pair`` a unit, the ``engine.stream.cursor`` gauge and
``engine/finalize``.  JAX's accumulated ``run`` is one scan, so it records
no unit spans; the port's runs the stream's units without theirs.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, Optional, Sequence, Union

import torch

from repro_torch import obs

from .extensions import (
    Extension,
    ExtensionConfig,
    FusedMask,
    FusedSecondMask,
    by_name,
    first_order_mask,
    reduce_spec,
    second_order_mask,
    sweeps_needed,
)
from .loss_hessian import MCUniforms, _f32, draw_uniforms
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

    def accumulate(self, num_microbatches: int) -> "AccumulatedSweepPlan":
        """Bind this plan to a schedule of ``num_microbatches`` slices of
        ``ceil(N / num_microbatches)`` samples (the last may be smaller):
        the accumulated lane, :class:`AccumulatedSweepPlan`."""
        return AccumulatedSweepPlan(plan=self, num_microbatches=int(num_microbatches))

    def run(self, model, params, inputs, targets, loss,
            cfg: Optional[ExtensionConfig] = None, rng=None) -> "Results":
        """:func:`run` for this plan's extensions."""
        extensions = tuple(by_name(n) for n in sorted(self.names))
        with obs.span("engine/sweep", lane="monolithic", extensions=",".join(sorted(self.names))):
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


def refuse_mesh(what: str, mesh, shard_axes=("data",)) -> None:
    """Raise for a ``mesh``: the batch-sharded lane is ROADMAP queue A item
    12, and no entry point runs another lane in its place."""
    if mesh is not None:
        raise NotImplementedError(
            f"{what}: the sharded lane (mesh over {tuple(shard_axes)}) is "
            "not ported yet (ROADMAP queue A item 12)")


def plan_for_batch(extensions, cfg: Optional[ExtensionConfig], n: int, mesh=None,
                   shard_axes=("data",), microbatch_size: Optional[int] = None
                   ) -> Union[SweepPlan, "AccumulatedSweepPlan"]:
    """The sweep lane for a batch of ``n`` samples: the consumers' (the
    extended train step, the Laplace fits) one place to compose it.

    A ``microbatch_size`` (the argument, or ``cfg.microbatch_size``) that
    cuts the batch into more than one slice gives the accumulated lane,
    :class:`AccumulatedSweepPlan`; otherwise the single-device
    :class:`SweepPlan`.  A ``mesh`` (the batch-sharded lane, ROADMAP queue A
    item 12) raises, rather than running another lane silently.
    """
    refuse_mesh("plan_for_batch", mesh, shard_axes)
    cfg = cfg or ExtensionConfig()
    plan = plan_sweeps(extensions, cfg)
    mb = microbatch_size or cfg.microbatch_size
    k = -(-n // mb) if mb else 1
    return plan.accumulate(k) if k > 1 else plan


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


class _ScaledLoss:
    """Loss adapter for a slice of the batch: rescales its 1/M_local to the
    whole batch's 1/M_global.

    Every loss here normalizes by its number M of sample units; a slice sees
    only its own.  The accumulated lane counts M_global once, mask-aware,
    from the whole batch's targets (``total_units``) and passes it in, so
    per-sample quantities match the monolithic sweep even where masks leave
    the slices' unit counts uneven.  ``value`` and ``hessian_mean`` return
    the slice's contribution (the lane sums them).  The MC factor takes its
    draws from the whole batch's (uniforms or draws ``[k, N, ...]``) at the
    slice's sample indices ``[sample_offset, sample_offset + n)``.
    """

    def __init__(self, base, total_units, sample_offset=0):
        self.base = base
        self.total_units = total_units
        self.sample_offset = sample_offset

    def __getattr__(self, name):
        return getattr(self.base, name)

    def _ratio(self, y, dtype):
        """M_local / M_global in ``dtype``.  The local clamp mirrors the base
        loss's own ≥ 1 clamp (what its outputs were divided by); the global
        one only guards a batch masked throughout."""
        ml = self.base.num_units(y).double().clamp_min(1.0)
        mg = torch.as_tensor(self.total_units, device=ml.device).double().clamp_min(1.0)
        return (ml / mg).to(dtype)

    def value(self, z, y):
        v = self.base.value(z, y)
        return v * self._ratio(y, v.dtype)

    def grad(self, z, y):
        g = self.base.grad(z, y)
        gf = _f32(g)
        return (gf * self._ratio(y, gf.dtype)).to(g.dtype)

    def n_exact_cols(self, z):
        return self.base.n_exact_cols(z)

    def _scale_factor(self, S, y):
        Sf = _f32(S)
        return (Sf * self._ratio(y, torch.float64).sqrt().to(Sf.dtype)).to(S.dtype)

    def sqrt_hessian(self, z, y):
        return self.sqrt_hessian_chunk(z, y, 0, self.n_exact_cols(z))

    def sqrt_hessian_chunk(self, z, y, lo, size):
        return self._scale_factor(self.base.sqrt_hessian_chunk(z, y, lo, size), y)

    def sqrt_hessian_mc(self, rng, z, y, k=1):
        off, n = self.sample_offset, z.shape[0]
        if isinstance(rng, MCUniforms):
            rng = rng.rows(off, n)
        elif isinstance(rng, torch.Tensor):
            rng = rng[:, off:off + n]
        return self._scale_factor(self.base.sqrt_hessian_mc(rng, z, y, k), y)

    def hessian_mean(self, z, y):
        H = self.base.hessian_mean(z, y)
        return H * self._ratio(y, H.dtype)

    def hessian_vec(self, z, y, v):
        # Per sample, like ``grad``: the slice's 1/M_local becomes 1/M_global
        # (the matrix-free products sum the slices' parameter-space results).
        hv = self.base.hessian_vec(z, y, v)
        hf = _f32(hv)
        return (hf * self._ratio(y, hf.dtype)).to(hv.dtype)


def _moment_triple(sum_g2, grad_sum, n):
    """(count, mean, M2) triple of a partial batch from its (Σg², Σg)."""
    g1 = grad_sum.to(sum_g2.dtype)
    nl = torch.tensor(float(n), dtype=sum_g2.dtype, device=sum_g2.device)
    return nl, g1 / nl, sum_g2 - g1 ** 2 / nl


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
    # A slice run of the accumulated lane: the loss normalized as the whole
    # batch's, so every per-sample quantity matches the monolithic sweep.
    if cfg.total_units is not None:
        loss = _ScaledLoss(loss, cfg.total_units, cfg.sample_offset)

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
        # A slice run scales by the whole batch's sample count.
        n_total = float(cfg.total_batch if cfg.total_batch is not None else n)
        if "second_moment" in names:
            ext["second_moment"] = tree_map(lambda s: s * n_total, sum_g2)
        if "variance" in names:
            if cfg.accum_stats:
                # The slice's mergeable (count, mean, M2) triple: the lane
                # folds triples by the Chan merge and finalizes n·M2.
                def triple(s, gr):
                    t = _moment_triple(s, gr, n)
                    return {"n": t[0], "mean": t[1], "m2": t[2]}

                ext["variance"] = _zip_stats(triple, sum_g2, grads)
            else:
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
        if cfg.accum_stats:
            # A slice run emits the streamable halves of the recursion: Ḡ's
            # contribution and the per-layer batch-mean partials; the lane
            # folds both and replays the chain once (every batch-dependent
            # quantity of Eq. 24 is a batch mean).
            ext["kfra"] = {"gbar": Gbar,
                           "partials": model.kfra_partials(params, tape, cfg)}
        else:
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
        if isinstance(b_node, dict):  # a Wired module's children by name
            return {k: rec(v, a_node.get(k) if isinstance(a_node, dict) else None)
                    for k, v in b_node.items()}
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
    out = _f32(leaves[0])
    for leaf in leaves[1:]:
        out = out + _f32(leaf)
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


# ---------------------------------------------------------------------------
# the accumulated lane (SweepPlan.accumulate)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AccumulatedSweepPlan:
    """A :class:`SweepPlan` bound to a schedule of slices: the accumulated
    lane.

    ``run`` runs the plan's sweep once per slice of the batch and folds the
    results through each extension's :class:`Reducer` as a sequential
    accumulator: running sums (psum), a sample-weighted A mean and summed B
    (kron), rows written in sample order (concat), the Chan moment merge
    (moment_merge), KFRA's weighted partial means and one replay of the
    chain (pmean), and for the pairwise family (BatchDot, the NTKs, GGNGram)
    the diagonal blocks from the slices and one extra pass per slice pair
    for the off-diagonal blocks, scattered into an ``[N, N, ...]`` buffer.
    Each slice's loss is normalized by the whole batch's mask-aware unit
    count, and its MC draws are the whole batch's at its sample indices, so
    the results match the monolithic sweep up to summation order while
    activation and factor memory scale with the slice.

    ``run`` is :class:`SweepStream` driven to its end, and
    ``run_checkpointed`` / ``resume`` drive the same stream with snapshots:
    one schedule and one code path.  A reducer with ``supports_streaming =
    False`` is refused.
    """

    plan: SweepPlan
    num_microbatches: int

    def __post_init__(self):
        if self.num_microbatches < 1:
            raise ValueError("num_microbatches must be >= 1 "
                             f"(got {self.num_microbatches})")

    def describe(self) -> str:
        red = reduce_spec([by_name(nm) for nm in sorted(self.plan.names)])
        accs = ", ".join(f"{nm}:{r.name}({r.streaming_form})"
                         for nm, r in sorted(red.items()))
        return (f"{self.plan.describe()} | accumulate={self.num_microbatches} "
                f"microbatches (sequential reduce: {accs})")

    def _check_extensions(self, extensions):
        red = reduce_spec(extensions)
        bad = sorted(nm for nm, r in red.items() if not r.supports_streaming)
        if bad:
            kinds = ", ".join(f"{nm} ({red[nm].name})" for nm in bad)
            raise ValueError(
                f"extensions [{kinds}] have no sequential accumulator: "
                "their reducers declare supports_streaming=False — the "
                "whole batch must be resident at once.  Run them on a "
                "monolithic sweep, implement the streaming protocol on the "
                "reducer, or drop them from the accumulated plan.")
        return red

    def run(self, model, params, inputs, targets, loss,
            cfg: Optional[ExtensionConfig] = None, rng=None) -> Results:
        """The accumulated :func:`run`: the same signature minus
        ``extensions`` (the plan carries them), the same Results."""
        n = tree_leaves(inputs)[0].shape[0]
        with obs.span("engine/sweep", lane="accumulated", k=self.num_microbatches, n=n,
                      extensions=",".join(sorted(self.plan.names))):
            stream = SweepStream(self, model, params, inputs, targets, loss, cfg=cfg, rng=rng)
            for unit in stream.units:
                stream._run_unit(unit)
            stream._cursor = len(stream.units)
            return stream.result()

    def stream(self, model, params, inputs, targets, loss,
               cfg: Optional[ExtensionConfig] = None, rng=None) -> "SweepStream":
        """The checkpointable stepwise executor of this plan (most callers
        want :meth:`run_checkpointed` / :meth:`resume`); a reducer with
        ``supports_checkpoint = False`` is refused."""
        red = reduce_spec(SweepStream.extensions_of(self))
        bad = sorted(nm for nm, r in red.items() if not r.supports_checkpoint)
        if bad:
            kinds = ", ".join(f"{nm} ({red[nm].name})" for nm in bad)
            raise ValueError(
                f"extensions [{kinds}] cannot be checkpointed: their "
                "reducers declare supports_checkpoint=False — the "
                "accumulator state does not round-trip through "
                "serialize/deserialize.  Run them on an uncheckpointed "
                "sweep, implement serialize/deserialize on the reducer, "
                "or drop them from the checkpointed plan.")
        return SweepStream(self, model, params, inputs, targets, loss, cfg=cfg, rng=rng)

    def run_checkpointed(self, model, params, inputs, targets, loss,
                         cfg: Optional[ExtensionConfig] = None, rng=None, *,
                         checkpointer=None, checkpoint_every: int = 1,
                         injector=None, resume: bool = False) -> Results:
        """Run the accumulated sweep with snapshots.

        Drives a :class:`SweepStream` unit by unit, saving its state through
        ``checkpointer`` every ``checkpoint_every`` units and at the end.  A
        process killed mid-sweep restarts with ``resume=True`` (or
        :meth:`resume`) from the last snapshot and gives the results of an
        uninterrupted run.

        Parameters
        ----------
        checkpointer : object, optional
            ``save(cursor, state, meta)`` and ``restore_latest(state_like)
            -> (cursor, state, meta) | None``
            (:class:`repro_torch.train.checkpoint.SweepCheckpointer`);
            ``None`` runs without snapshots.
        checkpoint_every : int
            Save cadence in work units (at least 1).
        injector : object, optional
            ``injector.check(cursor)`` before each unit
            (:class:`repro_torch.train.fault.FailureInjector`).
        resume : bool
            Restore the latest snapshot first (none is a cold start;
            :meth:`resume` is the strict form).
        """
        stream = self.stream(model, params, inputs, targets, loss, cfg=cfg, rng=rng)
        if checkpointer is not None:
            stream.require_replayable()
            if resume:
                snap = checkpointer.restore_latest(stream.state_arrays())
                if snap is not None:
                    stream.load_state(*snap)
        return _drive_stream(stream, checkpointer, checkpoint_every, injector)

    def resume(self, model, params, inputs, targets, loss, checkpointer,
               cfg: Optional[ExtensionConfig] = None, rng=None, *,
               checkpoint_every: int = 1, injector=None) -> Results:
        """Restart an interrupted checkpointed sweep, strictly: restore the
        latest snapshot (``FileNotFoundError`` when there is none) and drive
        the remaining units.  The caller rebuilds the inputs as they were
        (batch, extensions, loss, cfg, ``mc_seed`` or draws); the snapshot's
        schedule is checked against them, naming the first field that
        differs."""
        stream = self.stream(model, params, inputs, targets, loss, cfg=cfg, rng=rng)
        stream.require_replayable()
        snap = checkpointer.restore_latest(stream.state_arrays())
        if snap is None:
            raise FileNotFoundError(
                "resume(...) found no sweep snapshot to restore — run "
                "run_checkpointed(...) first, or call it with resume=True "
                "to tolerate a cold start")
        stream.load_state(*snap)
        return _drive_stream(stream, checkpointer, checkpoint_every, injector)


def _drive_stream(stream, checkpointer, checkpoint_every, injector):
    """Drive a :class:`SweepStream` to its end with periodic snapshots.

    ``injector.check(cursor)`` runs before each unit, so a fault injected at
    cursor j leaves units 0..j-1 done and their last snapshot on disk: what a
    preempted process leaves behind."""
    every = max(1, int(checkpoint_every))
    while not stream.done:
        if injector is not None:
            injector.check(stream.cursor)
        stream.step()
        if checkpointer is not None and (stream.done or stream.cursor % every == 0):
            checkpointer.save(stream.cursor, stream.state_arrays(), stream.schedule_meta())
    return stream.result()


def _slice_rows(tree, lo, n):
    return tree_map(lambda a: a[lo:lo + n], tree)


class SweepStream:
    """Stepwise, checkpointable executor of an accumulated sweep.

    The schedule follows the JAX package's: with m = ⌈N / k⌉ rows a slice,
    ``k_full`` = N // m full slices and a tail of N − k_full·m rows, the
    work units are the slices in order, then one pair pass per pair (p < q)
    of full slices, then the tail's pairs.  :meth:`step` runs the next unit
    and folds it into ``state``, a tree of tensors only: the summed loss and
    gradients, each reducer's accumulator, buffers of the whole batch's
    per-sample rows and logits, and ``[N, N, ...]`` pairwise buffers (the
    lower block of a pair is ``reducer.transpose_block`` of the upper).

    Between two units ``(cursor, state)`` is a complete snapshot:
    :meth:`state_arrays` serializes it (``Reducer.serialize``),
    :meth:`load_state` restores it, and :meth:`schedule_meta` carries what a
    restore is checked against.  A snapshot at cursor j and the rebuilt
    inputs reproduce the uninterrupted run: the MC uniforms are drawn once,
    for the whole batch, before the first slice (the monolithic sweep's
    call and shape), and each slice takes its columns.

    The state's structure is taken from the first slice's results, or,
    when a snapshot is to be restored before any unit ran, from one sample
    run without kernels (:meth:`state_arrays`).
    """

    def __init__(self, plan: AccumulatedSweepPlan, model, params, inputs, targets, loss,
                 cfg: Optional[ExtensionConfig] = None, rng=None):
        cfg = cfg or ExtensionConfig()
        self.plan = plan
        self.model, self.params = model, params
        self.inputs, self.targets, self.loss = inputs, targets, loss
        self.extensions = self.extensions_of(plan)
        self.red = plan._check_extensions(self.extensions)
        self.pair_names = [e.name for e in self.extensions if self.red[e.name].pairwise]
        self.concat_names = [e.name for e in self.extensions if self.red[e.name].streams_rows]
        self.carry_names = [e.name for e in self.extensions
                            if not (self.red[e.name].pairwise or self.red[e.name].streams_rows)]
        self._pair_exts = tuple(e for e in self.extensions if e.name in self.pair_names)

        first = tree_leaves(inputs)[0]
        self.device = first.device
        n = first.shape[0]
        k = max(1, min(int(plan.num_microbatches), n))
        self.n = n
        self.m = m = -(-n // k)
        self.k_full = n // m
        self.rem = n - self.k_full * m
        self.n_slices = self.k_full + (1 if self.rem else 0)

        # The MC draws: the whole batch's, made once.
        self._rng_source, self.draws = None, None
        if "ggn_mc" in plan.plan.sweeps:
            self._rng_source = ("generator" if isinstance(rng, torch.Generator)
                                else "draws" if rng is not None
                                else f"mc_seed={cfg.mc_seed}")
            rng = _default_rng(plan.plan.sweeps, cfg, rng, self.device)
            self.draws = (draw_uniforms(rng, targets, cfg.mc_samples)
                          if isinstance(rng, torch.Generator) else rng)
        self.cfg = dataclasses.replace(
            cfg, total_units=loss.num_units(targets), total_batch=n,
            accum_stats=True, cross_split=None, sample_offset=0)

        units = [("slice", t) for t in range(self.n_slices)]
        if self.pair_names:
            units += [("pair", p * m, q * m, m)
                      for p in range(self.k_full) for q in range(p + 1, self.k_full)]
            if self.rem:
                units += [("pair", p * m, self.k_full * m, self.rem)
                          for p in range(self.k_full)]
        self.units = units
        self._cursor = 0
        self.state = None

    @staticmethod
    def extensions_of(plan: AccumulatedSweepPlan) -> tuple:
        """The plan's extensions: its own objects first, so custom
        first-sweep extensions stream too; the registry gives the rest."""
        local = {e.name: e for e in plan.plan.first_exts + plan.plan.kron_exts}
        return tuple(local.get(nm) or by_name(nm) for nm in sorted(plan.plan.names))

    # -- schedule -------------------------------------------------------------

    @property
    def cursor(self) -> int:
        """Index of the next work unit (the snapshot step)."""
        return self._cursor

    @property
    def num_units(self) -> int:
        """Work units: the slices, then the pair passes."""
        return len(self.units)

    @property
    def done(self) -> bool:
        return self._cursor >= len(self.units)

    def describe(self) -> str:
        pairs = len(self.units) - self.n_slices
        return (f"{self.plan.describe()} | stream: {self.n_slices} slice "
                f"units ({self.m} rows each) + {pairs} pair units, "
                f"cursor={self._cursor}/{len(self.units)}")

    def require_replayable(self):
        """Raise unless a rebuilt stream draws what this one draws: a
        ``torch.Generator`` the caller passed has been consumed and cannot
        be replayed, so a checkpointed MC sweep takes ``mc_seed`` or draws."""
        if self._rng_source == "generator":
            raise ValueError(
                "a checkpointed sweep with MC extensions needs its draws to be "
                "rebuilt on resume: set ExtensionConfig(mc_seed=...) or pass "
                "the draws (uniforms or class indices) as rng=, not a "
                "torch.Generator, whose consumed state cannot be replayed")

    # -- per-unit execution -----------------------------------------------------

    def _slice_run(self, lo, rows, cfg):
        return run(self.model, self.params, _slice_rows(self.inputs, lo, rows),
                   _slice_rows(self.targets, lo, rows), self.loss,
                   extensions=self.extensions,
                   cfg=dataclasses.replace(cfg, sample_offset=lo), rng=self.draws)

    def _init_state(self, res):
        def rows_buf(v):
            return torch.zeros((self.n,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)

        def pair_buf(v):
            return torch.zeros((self.n, self.n) + tuple(v.shape[2:]), dtype=v.dtype,
                               device=v.device)

        self.state = {
            "loss": torch.zeros_like(res.loss),
            "grads": tree_map(torch.zeros_like, res.grads),
            "carry": {nm: self.red[nm].init(tree_map(torch.zeros_like, res.ext[nm]))
                      for nm in self.carry_names},
            "logits": tree_map(rows_buf, res.logits),
            "rows": {nm: tree_map(rows_buf, res.ext[nm]) for nm in self.concat_names},
            "pair": {nm: tree_map(pair_buf, res.ext[nm]) for nm in self.pair_names},
        }

    def step(self) -> int:
        """Run the next work unit; returns the advanced cursor."""
        if self.done:
            raise ValueError("sweep stream already complete — result() "
                             "holds the finalized Results")
        unit = self.units[self._cursor]
        if unit[0] == "slice":
            t = unit[1]
            span = obs.span("engine/stream/slice", t=t,
                            rows=self.m if t < self.k_full else self.rem)
        else:
            span = obs.span("engine/stream/pair", off_p=unit[1], off_q=unit[2], rows_q=unit[3])
        with span:
            self._run_unit(unit)
        self._cursor += 1
        obs.gauge("engine.stream.cursor", self._cursor)
        return self._cursor

    def _run_unit(self, unit):
        if unit[0] == "slice":
            self._do_slice(unit[1])
        else:
            self._do_pair(*unit[1:])

    def _do_slice(self, t):
        lo = t * self.m
        rows = self.m if t < self.k_full else self.rem
        res = self._slice_run(lo, rows, self.cfg)
        if self.state is None:
            self._init_state(res)
        st = self.state
        meta = {"weight": float(rows)}
        st["loss"] = st["loss"] + res.loss
        st["grads"] = tree_map(torch.add, st["grads"], res.grads)
        st["carry"] = {nm: self.red[nm].update(st["carry"][nm], res.ext[nm], meta)
                       for nm in self.carry_names}

        def put(buf, v):
            buf[lo:lo + rows] = v

        def put_diag(buf, blk):
            buf[lo:lo + rows, lo:lo + rows] = blk

        tree_map(put, st["logits"], res.logits)
        for nm in self.concat_names:
            tree_map(put, st["rows"][nm], res.ext[nm])
        for nm in self.pair_names:
            tree_map(put_diag, st["pair"][nm], res.ext[nm])

    def _do_pair(self, off_p, off_q, rows_q):
        m = self.m

        def cut(a):
            return torch.cat([a[off_p:off_p + m], a[off_q:off_q + rows_q]], 0)

        cfg_p = dataclasses.replace(self.cfg, cross_split=m)
        res = run(self.model, self.params, tree_map(cut, self.inputs),
                  tree_map(cut, self.targets), self.loss, extensions=self._pair_exts,
                  cfg=cfg_p)
        for nm in self.pair_names:
            reducer = self.red[nm]

            def put(buf, blk):
                buf[off_p:off_p + m, off_q:off_q + rows_q] = blk
                buf[off_q:off_q + rows_q, off_p:off_p + m] = reducer.transpose_block(blk)

            tree_map(put, self.state["pair"][nm], res.ext[nm])

    # -- snapshots --------------------------------------------------------------

    def state_arrays(self):
        """The checkpoint payload: ``state`` with every reducer accumulator
        through :meth:`Reducer.serialize`, a tree of tensors of one
        structure and one set of shapes over the stream's life.  Before any
        unit ran, the structure comes from one sample's sweep without
        kernels (no launch), zeroed."""
        if self.state is None:
            res = self._slice_run(0, 1, dataclasses.replace(self.cfg, use_kernels=False))
            self._init_state(res)
        st = dict(self.state)
        st["carry"] = {nm: self.red[nm].serialize(self.state["carry"][nm])
                       for nm in self.carry_names}
        return st

    def _draws_digest(self) -> Optional[str]:
        if self.draws is None:
            return None
        d = self.draws.u if isinstance(self.draws, MCUniforms) else self.draws
        return hashlib.sha256(d.detach().cpu().contiguous().numpy().tobytes()).hexdigest()

    def schedule_meta(self) -> dict:
        """The schedule a resumed stream must rebuild, saved beside each
        snapshot (JSON): batch rows, slices, extensions, loss, MC samples,
        where the draws come from (``rng``) and a digest of them."""
        return {
            "n": int(self.n),
            "num_microbatches": int(self.plan.num_microbatches),
            "slice_rows": int(self.m),
            "work_units": len(self.units),
            "extensions": sorted(self.plan.plan.names),
            "loss": type(self.loss).__name__,
            "mc_samples": int(self.cfg.mc_samples),
            "rng": self._rng_source,
            "draws": self._draws_digest(),
        }

    def check_meta(self, meta: dict) -> None:
        """Check a snapshot's schedule against this stream; ``ValueError``
        names the first field that differs."""
        for field, now in self.schedule_meta().items():
            if field in meta and meta[field] != now:
                raise ValueError(
                    "sweep snapshot does not match this stream: field "
                    f"{field!r} was {meta[field]!r} at save time but is "
                    f"{now!r} now — resume must rebuild the stream with "
                    "the identical batch, microbatch schedule, "
                    "extensions, loss and mc_seed or draws")

    def load_state(self, cursor, arrays, meta: Optional[dict] = None):
        """Restore a snapshot: cursor, serialized state (tensors are moved
        to the stream's device) and, when kept, the schedule to check."""
        if meta is not None:
            self.check_meta(meta)
        cursor = int(cursor)
        if not 0 <= cursor <= len(self.units):
            raise ValueError(
                f"sweep snapshot cursor {cursor} outside this stream's "
                f"schedule of {len(self.units)} work units")
        arrays = dict(tree_map(lambda a: torch.as_tensor(a).to(self.device), arrays))
        arrays["carry"] = {nm: self.red[nm].deserialize(arrays["carry"][nm])
                           for nm in self.carry_names}
        self.state = arrays
        self._cursor = cursor

    # -- finalize ---------------------------------------------------------------

    def result(self) -> Results:
        """Finalize every accumulator; only once ``done``."""
        if not self.done:
            raise ValueError(
                f"sweep stream incomplete ({self._cursor}/"
                f"{len(self.units)} work units) — drive step() to "
                "completion (or use run_checkpointed) before result()")
        st = self.state
        meta_fin = {"total_batch": float(self.n), "total_units": self.cfg.total_units}
        if "kfra" in self.carry_names:
            meta_fin["replay"] = lambda gbar, parts: _merge_stat_trees(
                self.model.kfra_apply(self.params, gbar, parts, self.extensions,
                                      self.cfg)[1], "kfra")
        ext = {}
        for nm in self.carry_names:
            with obs.span("engine/finalize", ext=nm, reducer=self.red[nm].name):
                ext[nm] = self.red[nm].finalize(st["carry"][nm], meta_fin)
        ext.update(st["rows"])
        ext.update(st["pair"])
        return Results(loss=st["loss"], grads=st["grads"], logits=st["logits"], ext=ext)
