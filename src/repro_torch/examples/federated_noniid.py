"""Server optimization & drift correction on label-sharded non-IID clients.

The paper's hard setting — 2-sample single-class clients (alpha=0 label
sharding) — is exactly where a fixed server average struggles: per-round
pseudo-gradients are noisy and badly scaled, and with multiple local steps
the client updates drift apart. This scenario trains the same DCCO engine
run under different repro_torch.server strategies and reports
linear-probe accuracy:

  fedavg_sgd      — plain FedAvg: the server applies the average delta
                    (SGD at server lr 1.0); the baseline.
  fedavgm         — server heavy-ball momentum.
  fedadam         — Reddi-style adaptive server optimizer (tau-damped
                    per-parameter preconditioning of the pseudo-gradient).
  fedadam+scaffold— adaptivity on the server plus SCAFFOLD control
                    variates; under cohort sampling the per-slot variates
                    reshape the update even at one local step.

Every row sees the identical cohort/augmentation stream, differing only in
the server/drift strategy, so the probe columns are directly comparable.

Run: PYTHONPATH=src python -m repro_torch.examples.federated_noniid
     [--rounds 50] [--device cpu] (CI smoke: --rounds 3 --dataset-size 120)
"""
from __future__ import annotations

import argparse

from repro_torch.core import round_engine
from repro_torch.examples import _common
from repro_torch.server import get_server_update

ROWS = [
    ("fedavg_sgd (baseline)",
     lambda: get_server_update("fedavg_sgd", server_lr=1.0), {}),
    ("fedavgm",
     lambda: get_server_update("fedavgm", server_lr=0.5), {}),
    ("fedadam",
     lambda: get_server_update("fedadam", server_lr=3e-2, tau=1e-2), {}),
    ("fedadam+scaffold",
     lambda: get_server_update("fedadam", server_lr=1e-2, tau=1e-2),
     {"scaffold": True}),
]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--dataset-size", type=int, default=600)
    ap.add_argument("--classes", type=int, default=5)
    ap.add_argument("--clients-per-round", type=int, default=8,
                    help="small cohorts = noisy pseudo-gradients, the "
                         "regime server adaptivity targets")
    ap.add_argument("--noise", type=float, default=1.0,
                    help="synthetic dataset difficulty")
    _common.add_device_flag(ap)
    args = ap.parse_args(argv)

    s = _common.resnet_setup(args, noise=args.noise)
    params0, device = s.params0, s.device
    # alpha=0: every client holds 2 samples of ONE class — the paper's
    # hard label-sharded split
    ds = _common.label_sharded(
        {"images": s.imgs}, s.labels,
        num_clients=max(args.dataset_size // 2, 8), samples_per_client=2)
    sampler = ds.make_round_sampler(args.clients_per_round, device)

    print(f"label-sharded non-IID split: "
          f"{ds.num_clients} single-class 2-sample clients, "
          f"{args.clients_per_round}/round, {args.rounds} rounds")
    print(f"{'strategy':>28s} {'loss':>10s} {'probe':>7s}")
    rows, base_acc = {}, None
    for name, make_su, extra in ROWS:
        su = make_su()
        ecfg = round_engine.EngineConfig(
            algorithm="dcco", lam=5.0,
            chunk_rounds=min(args.rounds, 25), server_update=su, **extra)
        eng = round_engine.RoundEngine(s.apply, su, sampler, ecfg)
        p, _, m = eng.run(params0, su.init(params0), 7, args.rounds)
        acc = s.probe(p)
        if base_acc is None:
            base_acc = acc
        rows[name] = {"losses": m.loss.cpu().tolist(), "probe": acc}
        print(f"{name:>28s} {float(m.loss[-1]):10.3f} {acc:7.3f}"
              f"  ({acc - base_acc:+.3f} vs baseline)", flush=True)
    probe0 = s.probe(params0)
    print(f"{'random init':>28s} {'-':>10s} {probe0:7.3f}")
    return {"rows": rows, "probe_init": probe0}


if __name__ == "__main__":
    main()
