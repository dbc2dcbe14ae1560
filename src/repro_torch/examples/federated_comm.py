"""Deployable-regime DCCO: the same federated pretraining run under four
client->server communication channels (repro_torch.comm) — ideal dense
uplink, int8 stochastic-rounding quantization, DP-noised aggregation, and
Bernoulli client dropout — with bytes-on-the-wire and (for DP) epsilon
reported next to linear-probe accuracy.

Every channel sees the identical cohort/augmentation stream (the channel
seed is folded off the round seed, so sampling is unchanged), which makes
the columns directly comparable: what you pay in bytes or privacy noise
vs what you keep in probe accuracy.

Run: PYTHONPATH=src python -m repro_torch.examples.federated_comm
     [--rounds 40] [--device cpu] (CI smoke: --rounds 3 --dataset-size 120)
"""
from __future__ import annotations

import argparse

from repro_torch import comm
from repro_torch.core import round_engine
from repro_torch.examples import _common
from repro_torch.optim import optimizers as opt_lib


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--dataset-size", type=int, default=600)
    ap.add_argument("--classes", type=int, default=5)
    ap.add_argument("--clients-per-round", type=int, default=16)
    ap.add_argument("--dp-sigma", type=float, default=0.3)
    ap.add_argument("--dropout-p", type=float, default=0.3)
    _common.add_device_flag(ap)
    args = ap.parse_args(argv)

    s = _common.resnet_setup(args)
    params0, device = s.params0, s.device
    # single-class 2-sample clients: the paper's hard non-IID setting
    ds = _common.label_sharded(
        {"images": s.imgs}, s.labels,
        num_clients=max(args.dataset_size // 2, 8), samples_per_client=2)
    sampler = ds.make_round_sampler(args.clients_per_round, device)

    channels = [
        ("dense (ideal)", comm.DenseChannel()),
        ("int8 quantized", comm.QuantizedChannel(8)),
        (f"DP sigma={args.dp_sigma}",
         comm.DPGaussianChannel(args.dp_sigma, clip_norm=10.0)),
        (f"dropout p={args.dropout_p}",
         comm.DropoutChannel(args.dropout_p)),
    ]
    rows = {}
    print(f"{'channel':>18s} {'loss':>10s} {'probe':>7s} "
          f"{'uplink MB':>10s} {'epsilon':>8s}")
    for name, ch in channels:
        opt = opt_lib.adam(2e-3)
        ecfg = round_engine.EngineConfig(
            algorithm="dcco", lam=5.0,
            chunk_rounds=min(args.rounds, 25), channel=ch)
        eng = round_engine.RoundEngine(s.apply, opt, sampler, ecfg)
        p, _, m = eng.run(params0, opt.init(params0), 7, args.rounds)
        acct = getattr(ch, "accountant", None)
        epsilon = acct.epsilon() if acct is not None else float("inf")
        eps = f"{epsilon:8.1f}" if acct is not None else "     inf"
        acc = s.probe(p)
        uplink_mb = float(m.wire_bytes.sum()) / 1e6
        rows[name] = {"losses": m.loss.cpu().tolist(), "probe": acc,
                      "uplink_mb": uplink_mb, "epsilon": epsilon}
        print(f"{name:>18s} {float(m.loss[-1]):10.3f} {acc:7.3f} "
              f"{uplink_mb:10.2f} {eps}", flush=True)
    probe0 = s.probe(params0)
    print(f"{'random init':>18s} {'-':>10s} {probe0:7.3f}")
    return {"rows": rows, "probe_init": probe0}


if __name__ == "__main__":
    main()
