"""Semi-synchronous buffered rounds under heavy-tail stragglers
(EngineConfig.async_k, repro_torch.core.buffer + repro_torch.data.latency).

The synchronous engine pays for its slowest client: a round costs
``1 + max(cohort delays)`` scheduler ticks, and under a heavy-tail latency
model one persistent straggler stalls the whole federation. The buffered
engine dispatches a cohort EVERY tick, folds contributions into a
staleness-weighted server buffer as they arrive, and applies the server
update whenever K contributions have accumulated — throughput is bounded
by the fold rate, not the tail of the latency distribution.

Part 1 — the straggler table. The same DCCO run as a synchronous engine
and as buffered engines at several K, all under the same heavy-tail
latency stream: simulated ticks per server update, probe accuracy, mean
applied staleness, and wire MB side by side.

Part 2 — exactness. With K = cohort, zero latency, and unit staleness the
buffered engine IS the synchronous engine, bit for bit (Eq. 3: the stats
are linear in samples, so the buffer only re-associates the weighted sum).

Run: PYTHONPATH=src python -m repro_torch.examples.federated_async
     [--rounds 30] [--device cpu] (CI smoke: --rounds 3 --dataset-size 120)
"""
from __future__ import annotations

import argparse

from repro_torch import utils
from repro_torch.core import round_engine
from repro_torch.data import latency as latency_lib
from repro_torch.examples import _common
from repro_torch.optim import optimizers as opt_lib


def sync_ticks(ds, lat, seed, cpr, rounds, device):
    """Simulated cost of the SYNC engine under the same latency stream:
    each round waits for its slowest sampled client (1 + max delay ticks).
    Replays the engine's own round seeds and the sampler's selection and
    delay draws, so the cohorts match."""
    total = 0
    for r in range(rounds):
        gen = utils.generator(seed * round_engine._ROUND_SEED_STRIDE + r,
                              device)
        sel = ds._select(gen, cpr)
        d = latency_lib.sample_delays(lat, latency_lib.delay_seed(gen), sel)
        total += 1 + int(d.max())
    return total


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--dataset-size", type=int, default=600)
    ap.add_argument("--classes", type=int, default=5)
    ap.add_argument("--clients-per-round", type=int, default=16)
    ap.add_argument("--latency-tail", type=float, default=0.7)
    _common.add_device_flag(ap)
    args = ap.parse_args(argv)

    s = _common.resnet_setup(args)
    params0, device = s.params0, s.device
    ds = _common.label_sharded(
        {"images": s.imgs}, s.labels,
        num_clients=max(args.dataset_size // 2, 8), samples_per_client=2)
    cpr = args.clients_per_round
    lat = latency_lib.LatencyModel("heavytail", horizon=8,
                                   tail=args.latency_tail, seed=0)
    asampler = ds.make_async_round_sampler(cpr, device, lat)
    seed = 7

    # ---- part 1: sync vs buffered under the same stragglers ------------
    s_ticks = sync_ticks(ds, lat, seed, cpr, args.rounds, device)
    print(f"heavy-tail stragglers (tail={args.latency_tail}, horizon=8), "
          f"{cpr} clients/tick, {args.rounds} ticks:")
    print(f"{'engine':>24s} {'updates':>8s} {'ticks/upd':>10s} "
          f"{'stale':>6s} {'loss':>9s} {'probe':>6s} {'wire MB':>8s}")

    rows = {}
    opt = opt_lib.adam(2e-3)
    eng = round_engine.RoundEngine(
        s.apply, opt, ds.make_round_sampler(cpr, device),
        round_engine.EngineConfig(algorithm="dcco", lam=5.0,
                                  chunk_rounds=min(args.rounds, 25)))
    p, _, m = eng.run(params0, opt.init(params0), seed, args.rounds)
    acc = s.probe(p)
    rows["sync"] = {"updates": args.rounds,
                    "ticks_per_update": s_ticks / args.rounds,
                    "losses": m.loss.cpu().tolist(), "probe": acc}
    print(f"{'sync (waits for tail)':>24s} {args.rounds:8d} "
          f"{s_ticks / args.rounds:10.2f} {0.0:6.2f} "
          f"{float(m.loss[-1]):9.3f} {acc:6.3f} "
          f"{float(m.wire_bytes.sum()) / 1e6:8.2f}", flush=True)

    for k in dict.fromkeys((max(cpr // 4, 1), max(cpr // 2, 1))):
        opt = opt_lib.adam(2e-3)
        eng = round_engine.RoundEngine(
            s.apply, opt, asampler,
            round_engine.EngineConfig(
                algorithm="dcco", lam=5.0,
                chunk_rounds=min(args.rounds, 25), async_k=k,
                staleness_fn="poly", latency=lat))
        p, _, m = eng.run(params0, opt.init(params0), seed, args.rounds)
        upd = int(m.applied.sum())
        stale = m.staleness[m.applied > 0]
        acc = s.probe(p)
        rows[f"buffered K={k}"] = {
            "updates": upd, "ticks_per_update": args.rounds / max(upd, 1),
            "losses": m.loss.cpu().tolist(), "probe": acc}
        print(f"{f'buffered K={k} (poly)':>24s} {upd:8d} "
              f"{args.rounds / max(upd, 1):10.2f} "
              f"{float(stale.mean()) if upd else 0.0:6.2f} "
              f"{float(m.loss[-1]):9.3f} {acc:6.3f} "
              f"{float(m.wire_bytes.sum()) / 1e6:8.2f}", flush=True)

    # ---- part 2: K = cohort, zero latency == the sync engine -----------
    opt = opt_lib.adam(2e-3)
    sync = round_engine.RoundEngine(
        s.apply, opt, ds.make_round_sampler(cpr, device),
        round_engine.EngineConfig(algorithm="dcco", lam=5.0, chunk_rounds=3))
    buf = round_engine.RoundEngine(
        s.apply, opt, ds.make_async_round_sampler(cpr, device, None),
        round_engine.EngineConfig(algorithm="dcco", lam=5.0, chunk_rounds=3,
                                  async_k=cpr))
    ps, _, _ = sync.run(params0, opt.init(params0), 9, 3)
    pb, _, _ = buf.run(params0, opt.init(params0), 9, 3)
    diff = utils.tree_max_abs_diff(ps, pb)
    print(f"\nbuffered K=cohort, zero latency vs sync engine: "
          f"max|diff| = {diff} (Eq. 3 exactness)")
    return {"rows": rows, "sync_ticks": s_ticks, "buffered_vs_sync": diff}


if __name__ == "__main__":
    main()
