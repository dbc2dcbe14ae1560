"""Paper Table-1 protocol end-to-end (miniaturized CIFAR-100 analogue):
compare DCCO vs FedAvg variants vs centralized CCO vs supervised-from-scratch
across decentralized splits (clients x samples/client, IID vs non-IID).

This is the end-to-end training driver example: federated rounds of a
(reduced) ResNet dual encoder per method and split, each driven by the
round engine (repro_torch.core.round_engine).

Run: PYTHONPATH=src python -m repro_torch.examples.federated_cifar
     [--rounds 60] [--device cpu] (CI smoke: --rounds 3 --dataset-size 120)
"""
from __future__ import annotations

import argparse

from repro_torch.core import round_engine
from repro_torch.examples import _common
from repro_torch.optim import optimizers as opt_lib, schedules

# Table-1 splits: (name, alpha, samples/client, clients/round)
SPLITS = [("non-IID s=1", 0.0, 1, 32), ("non-IID s=4", 0.0, 4, 8),
          ("IID s=4", 1e9, 4, 8)]
METHODS = ("dcco", "cco_fedavg", "contrastive_fedavg", "centralized")
ALGO = {"dcco": "dcco", "cco_fedavg": "fedavg_cco",
        "contrastive_fedavg": "fedavg_contrastive",
        "centralized": "centralized"}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--dataset-size", type=int, default=600)
    ap.add_argument("--classes", type=int, default=5)
    _common.add_device_flag(ap)
    args = ap.parse_args(argv)

    s = _common.resnet_setup(args)
    params0, device = s.params0, s.device
    table = {}
    print(f"{'split':14s} " + " ".join(f"{m:>20s}" for m in METHODS))
    for split_name, alpha, spc, cpr in SPLITS:
        ds = _common.label_sharded(
            {"images": s.imgs}, s.labels,
            num_clients=min(256, args.dataset_size // spc),
            samples_per_client=spc, alpha=alpha)
        sampler = ds.make_round_sampler(cpr, device)
        row = []
        for method in METHODS:
            if method == "cco_fedavg" and spc < 2:
                row.append("FAILED(n<2)")
                continue
            opt = opt_lib.adam(schedules.cosine_decay(2e-3, args.rounds))
            ecfg = round_engine.EngineConfig(
                algorithm=ALGO[method], lam=5.0,
                client_lr=0.5 if method.endswith("fedavg") else 1.0,
                chunk_rounds=min(args.rounds, 30))
            eng = round_engine.RoundEngine(s.apply, opt, sampler, ecfg)
            p, _, m = eng.run(params0, opt.init(params0), 1000, args.rounds)
            acc = s.probe(p)
            table[(split_name, method)] = (acc, m.loss.cpu().tolist())
            row.append(f"{acc:.3f}")
        print(f"{split_name:14s} " + " ".join(f"{v:>20s}" for v in row))
    print(f"{'supervised':14s} {'(limited labels below)':>20s}")
    probe0 = s.probe(params0)
    print(f"random-init probe: {probe0:.3f}")
    return {"table": table, "probe_init": probe0}


if __name__ == "__main__":
    main()
