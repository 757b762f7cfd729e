"""NTK-consumer launcher: GP regression, influence, subset selection.

    PYTHONPATH=src python -m repro_torch.launch.ntk_apps --gp --n-train 64 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.ntk_apps --influence --top 10
    PYTHONPATH=src python -m repro_torch.launch.ntk_apps --select-subset 16 \
        --method bait --microbatches 4

Runs the requested consumer on a papernets model (weights from a generator
seeded 0) over synthetic data drawn from a ``torch.Generator`` seeded 1, on
the card unless ``--device cpu`` is given.  ``--microbatches`` streams the
Jacobian sweep in row blocks; ``--trace-jsonl FILE`` records the
:mod:`repro_torch.obs` trace of the run (``ntk_apps/*`` spans; render it
with ``python -m repro_torch.obs.reporting FILE``).  Port of
``src/repro/launch/ntk_apps.py``: ``--shard-sweep`` (the sharded lane) is
ROADMAP queue A item 12 and raises.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import ntk_apps, obs
from repro_torch.configs import papernets
from repro_torch.core import CrossEntropyLoss, ExtensionConfig
from repro_torch.core.module import resolve_device


def _data(gen, n, dim, n_classes):
    x = torch.randn(n, dim, generator=gen)
    y = torch.randint(0, n_classes, (n,), generator=gen)
    return x, y


def main(argv=None):
    ap = argparse.ArgumentParser()
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--gp", action="store_true",
                      help="NTK-GP predictive mean/variance on a test split")
    mode.add_argument("--influence", action="store_true",
                      help="train→test influence scores + self-influence")
    mode.add_argument("--select-subset", type=int, metavar="K", default=None,
                      help="pick K pool points (see --method)")
    ap.add_argument("--model", default="mlp", choices=["logreg", "mlp", "c2d2"])
    ap.add_argument("--n-train", type=int, default=64)
    ap.add_argument("--n-test", type=int, default=16)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--ridge", type=float, default=1e-2)
    ap.add_argument("--damping", type=float, default=1e-2)
    ap.add_argument("--solver", default="cholesky", choices=["cholesky", "eigh", "lanczos"])
    ap.add_argument("--rank", type=int, default=None,
                    help="eigh truncation / lanczos preconditioner rank")
    ap.add_argument("--method", default="diversity", choices=["diversity", "bait"],
                    help="--select-subset strategy")
    ap.add_argument("--top", type=int, default=5, help="rows to print per result table")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="stream sweeps in this many row blocks (accumulated lane)")
    ap.add_argument("--shard-sweep", action="store_true",
                    help="assemble kernels on the sharded sweep lane")
    ap.add_argument("--trace-jsonl", default=None,
                    help="record the obs span trace to this JSONL file")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.shard_sweep:
        raise NotImplementedError("--shard-sweep (the sharded lane) is still to port: "
                                  "ROADMAP queue A item 12")
    if args.trace_jsonl:
        obs.enable(trace_jsonl=args.trace_jsonl)
    try:
        _run(args)
    finally:
        if args.trace_jsonl:
            obs.disable()  # close the sink so the trace file is complete
    if args.trace_jsonl:
        print(f"[obs] trace written to {args.trace_jsonl}")


def _run(args):
    device = resolve_device(args.device)
    init = torch.Generator().manual_seed(0)
    if args.model == "logreg":
        model = papernets.logreg(args.classes, args.dim, device=device, generator=init)
    elif args.model == "mlp":
        model = papernets.mlp(args.classes, args.dim, hidden=(64, 32), device=device,
                              generator=init)
    else:
        img = 8
        args.dim = img * img
        model = papernets.c2d2(args.classes, in_ch=1, img=img, device=device, generator=init)
    params = model.params()
    loss = CrossEntropyLoss()
    cfg = ExtensionConfig()

    data = torch.Generator().manual_seed(1)
    x_tr, y_tr = _data(data, args.n_train, args.dim, args.classes)
    x_te, y_te = _data(data, args.n_test, args.dim, args.classes)
    if args.model == "c2d2":
        x_tr, x_te = x_tr.reshape(-1, 8, 8, 1), x_te.reshape(-1, 8, 8, 1)
    x_tr, y_tr, x_te, y_te = (t.to(device) for t in (x_tr, y_tr, x_te, y_te))

    if args.gp:
        gp = ntk_apps.gp_predict(model, params, x_tr, y_tr, x_te, loss, ridge=args.ridge,
                                 solver=args.solver, rank=args.rank, cfg=cfg,
                                 microbatches=args.microbatches)
        print(f"[gp] on {device}: solver={gp.info.method} rank={gp.info.rank} "
              f"iters={gp.info.iters} resid={float(gp.info.resid):.2e}")
        pred = torch.argmax(gp.mean, dim=-1)
        for j in range(min(args.top, args.n_test)):
            print(f"  test[{j:3d}]  pred={int(pred[j])}  var={float(gp.var[j]):.4f}  "
                  f"mean={[round(float(v), 3) for v in gp.mean[j]]}")
    elif args.influence:
        inf = ntk_apps.influence_scores(model, params, x_tr, y_tr, x_te, y_te, loss,
                                        damping=args.damping, cfg=cfg,
                                        microbatches=args.microbatches)
        si = ntk_apps.self_influence(model, params, x_tr, y_tr, loss, damping=args.damping,
                                     cfg=cfg, microbatches=args.microbatches)
        total = inf.scores.sum(dim=1)
        order = torch.argsort(total, descending=True)
        print(f"[influence] on {device}: cg iters={inf.iters} "
              f"max resid={float(inf.resid.max()):.2e}; top train points by summed "
              "influence on the test split:")
        for i in map(int, order[:args.top]):
            print(f"  train[{i:3d}]  influence={float(total[i]):+.4f}  "
                  f"self={float(si.scores[i]):.4f}")
    else:
        sel = ntk_apps.select_subset(model, params, x_tr, y_tr, loss, args.select_subset,
                                     method=args.method, lam=args.damping, cfg=cfg,
                                     microbatches=args.microbatches)
        print(f"[select] on {device}: method={args.method} k={args.select_subset} "
              "picks (objective per step):")
        for t, (i, s) in enumerate(zip(sel.indices, sel.scores)):
            print(f"  step {t:3d}: pool[{int(i):3d}]  score={float(s):.4f}")


if __name__ == "__main__":
    main()
