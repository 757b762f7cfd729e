#!/usr/bin/env python3
"""Where float32 SLQ loses accuracy at 3C3D's width: ``log_marglik_matfree``
in float32, in float32 with the Lanczos reductions over the P = 1,353,962
parameters carried in float64, and in float64, on the same probes.

    python3 tools/slq_reductions.py [--rows 16] [--probes 4] [--iters 20]
                                    [--device cpu|cuda] [--threads T]

3C3D's weights come from seed 0 (as in ``chip_smoke.py``), the batch
(CIFAR-10-shaped inputs and labels) from a CPU generator seeded 3; the
probes are ``slq_logdet``'s default (a CPU generator seeded 0), so every
run sees the same ones.  The quadrature is ``P · Σ_j τ_j² log λ_j``: most
of a probe's weight sits on Ritz values near 1 (the ratio operator is
``I + (M/σ²δ)·G`` and G has rank ≤ rows · classes), so an absolute error ε
in those Ritz values moves the estimate by about P·ε.  The modes:

* ``float32``: the port as it is;
* ``float64_dots``: α's dot and β's norm summed in float64;
* ``float64_reductions``: those and the reorthogonalisation's ``V @ w``
  and ``Vᵀ(·)`` in float64 (the products stay float32);
* ``float64``: parameters and batch in float64.

Prints one JSON line: each mode's per-probe estimates and log-det ratio,
and each float32 mode's max |mode − float64| / max |float64| over the
per-probe estimates.  On the CPU it takes about a minute; ``--threads``
sets PyTorch's CPU threads (its default when not given), which changes the
order of the CPU's float32 sums and so the ``float32`` reading.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def lanczos_reduced(torch, wide_dots: bool, wide_reorth: bool):
    """``lanczos_tridiag`` with its reductions over the dimension summed in
    float64 (the dot and the norm with ``wide_dots``, the
    reorthogonalisation with ``wide_reorth``)."""
    def tridiag(mv_flat, v0, m):
        V = torch.zeros((m, v0.shape[0]), dtype=v0.dtype, device=v0.device)
        v, v_prev = v0, torch.zeros_like(v0)
        beta_prev = torch.zeros((), dtype=v0.dtype, device=v0.device)
        wide = torch.float64 if wide_dots else v0.dtype
        alphas, betas = [], []
        for i in range(m):
            V[i] = v
            w = mv_flat(v) - beta_prev * v_prev
            alpha = torch.dot(w.to(wide), v.to(wide)).to(v0.dtype)
            w = w - alpha * v
            if wide_reorth:
                V64, w64 = V.double(), w.double()
                w = (w64 - V64.T @ (V64 @ w64)).to(v0.dtype)
            else:
                w = w - V.T @ (V @ w)
            beta = torch.linalg.norm(w.to(wide)).to(v0.dtype)
            v, v_prev, beta_prev = w / beta.clamp_min(1e-30), v, beta
            alphas.append(alpha)
            betas.append(beta)
        return torch.stack(alphas), torch.stack(betas), V
    return tridiag


def main() -> int:
    import torch

    from repro_torch.configs import papernets
    from repro_torch.core import CrossEntropyLoss
    from repro_torch.core.tree import tree_map
    from repro_torch.curv import logdet
    from repro_torch.laplace import log_marglik_matfree

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, default=16)
    parser.add_argument("--probes", type=int, default=4)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--threads", type=int)
    args = parser.parse_args()
    if args.threads:
        torch.set_num_threads(args.threads)
    if args.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    model = papernets.c3d3(device=args.device, generator=torch.Generator().manual_seed(0))
    params = model.params()
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(args.rows, 32, 32, 3, generator=gen).to(args.device)
    y = torch.randint(0, 10, (args.rows,), generator=gen).to(args.device)
    loss = CrossEntropyLoss()
    kw = dict(prior_prec=1.0, probes=args.probes, iters=args.iters)
    params64 = tree_map(lambda a: a.double() if a.dtype.is_floating_point else a, params)

    plain = logdet.lanczos_tridiag
    modes = {"float32": (None, params, x), "float64_dots": ((True, False), params, x),
             "float64_reductions": ((True, True), params, x),
             "float64": (None, params64, x.double())}
    out = {"rows": args.rows, "probes": args.probes, "iters": args.iters,
           "device": args.device, "threads": torch.get_num_threads(), "modes": {}}
    for mode, (wide, prm, xx) in modes.items():
        logdet.lanczos_tridiag = lanczos_reduced(torch, *wide) if wide else plain
        try:
            ev = log_marglik_matfree(model, prm, xx, y, loss, **kw)
        finally:
            logdet.lanczos_tridiag = plain
        out["modes"][mode] = dict(per_probe=ev.per_probe.tolist(),
                                  log_det_ratio=ev.log_det_ratio)
    ref = torch.tensor(out["modes"]["float64"]["per_probe"], dtype=torch.float64)
    for mode, row in out["modes"].items():
        if mode != "float64":
            got = torch.tensor(row["per_probe"], dtype=torch.float64)
            row["rel_vs_float64"] = ((got - ref).abs().max() / ref.abs().max()).item()
    print(json.dumps(out, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
