"""The StatsObjective protocol end-to-end: the same two-phase federated
round (paper Fig. 2) training three different statistics-based losses —
D-CCO (the paper), D-VICReg (the Sec.-6 future-work extension), and
D-WMSE (whitening-style decorrelation) — on the same non-IID cohort
stream, through the round engine and an int8 quantized uplink.

Because the protocol only moves *statistics*, switching the objective is
one config field: the engine bodies, the comm channel, and the wire-bytes
accounting are all parametric in the objective's stats dict (D-VICReg /
D-WMSE ship 7 statistics per client where D-CCO ships 5 — visible in the
per-round payload column).

Run: PYTHONPATH=src python -m repro_torch.examples.federated_vicreg
     [--rounds 40] [--device cpu] (CI smoke: --rounds 3 --dataset-size 120)
"""
from __future__ import annotations

import argparse

from repro_torch import comm, objectives as objectives_lib
from repro_torch.core import round_engine
from repro_torch.examples import _common
from repro_torch.optim import optimizers as opt_lib

SPECS = [("dcco", {"lam": 5.0}), ("dvicreg", {}), ("dwmse", {})]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--dataset-size", type=int, default=600)
    ap.add_argument("--classes", type=int, default=5)
    ap.add_argument("--clients-per-round", type=int, default=16)
    ap.add_argument("--channel", default="int8",
                    choices=["none", "dense", "int8"],
                    help="client->server wire for both protocol phases")
    _common.add_device_flag(ap)
    args = ap.parse_args(argv)

    s = _common.resnet_setup(args)
    params0, device = s.params0, s.device
    # single-class 2-sample clients: the paper's hard non-IID setting
    ds = _common.label_sharded(
        {"images": s.imgs}, s.labels,
        num_clients=max(args.dataset_size // 2, 8), samples_per_client=2)
    sampler = ds.make_round_sampler(args.clients_per_round, device)

    rows = {}
    print(f"{'objective':>10s} {'stats':>6s} {'payload B':>10s} "
          f"{'loss':>10s} {'probe':>7s} {'uplink MB':>10s}")
    for name, hyper in SPECS:
        obj = objectives_lib.get_objective(name, **hyper)
        ch = comm.get_channel(args.channel)
        opt = opt_lib.adam(2e-3)
        ecfg = round_engine.EngineConfig(
            algorithm="dcco", objective=obj,
            chunk_rounds=min(args.rounds, 25), channel=ch)
        eng = round_engine.RoundEngine(s.apply, opt, sampler, ecfg)
        p, _, m = eng.run(params0, opt.init(params0), 7, args.rounds)
        tmpl = obj.stat_template(s.de.proj_dims[-1])
        payload_b = (ch or comm.DenseChannel()).payload_bytes(tmpl)
        acc = s.probe(p)
        uplink_mb = float(m.wire_bytes.sum()) / 1e6
        rows[name] = {"stats": len(obj.stat_keys), "payload_bytes": payload_b,
                      "losses": m.loss.cpu().tolist(), "probe": acc,
                      "uplink_mb": uplink_mb}
        print(f"{name:>10s} {len(obj.stat_keys):>6d} {payload_b:>10.0f} "
              f"{float(m.loss[-1]):>10.3f} {acc:>7.3f} "
              f"{uplink_mb:>10.2f}", flush=True)
    probe0 = s.probe(params0)
    print(f"{'random':>10s} {'-':>6s} {'-':>10s} {'-':>10s} "
          f"{probe0:>7.3f}")
    return {"rows": rows, "probe_init": probe0}


if __name__ == "__main__":
    main()
