"""Hierarchical aggregation + streaming mega-cohorts (repro_torch.hierarchy).

Part 1 — the two-level wire. The same federated DCCO run under three
aggregation topologies: flat dense (every client straight to the server),
a two-level tree with an int8 client->edge uplink and a dense edge->server
backbone, and the same tree with edge outages (an edge-hop DropoutChannel
— a failing edge takes ALL its clients down at once, the regional-outage
failure mode flat dropout cannot model). Per-hop uplink bytes are printed
next to probe accuracy; the dense-dense tree is bit-identical to flat
aggregation (Eq. 3: the payloads are linear in samples, so the summation
tree is semantically invisible).

Part 2 — the memory-free cohort knob. One round of an N-client cohort is
streamed through the engine in fixed-size chunks (EngineConfig.
cohort_chunk): peak batch memory is O(chunk) while the cohort grows
64 -> N, the regime of cross-device populations where rounds draw from
thousands of tiny clients.

Run: PYTHONPATH=src python -m repro_torch.examples.federated_hierarchy
     [--rounds 30] [--device cpu]
     (CI smoke: --rounds 3 --dataset-size 120 --mega-cohort 64)
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import comm, hierarchy, utils
from repro_torch.core import round_engine
from repro_torch.examples import _common
from repro_torch.optim import optimizers as opt_lib


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--dataset-size", type=int, default=600)
    ap.add_argument("--classes", type=int, default=5)
    ap.add_argument("--clients-per-round", type=int, default=16)
    ap.add_argument("--edges", type=int, default=4)
    ap.add_argument("--edge-dropout", type=float, default=0.25)
    ap.add_argument("--mega-cohort", type=int, default=256,
                    help="clients/round for the streaming demo")
    ap.add_argument("--cohort-chunk", type=int, default=32)
    _common.add_device_flag(ap)
    args = ap.parse_args(argv)

    s = _common.resnet_setup(args)
    params0, device = s.params0, s.device
    ds = _common.label_sharded(
        {"images": s.imgs}, s.labels,
        num_clients=max(args.dataset_size // 2, 8), samples_per_client=2)
    sampler = ds.make_round_sampler(args.clients_per_round, device)
    # a round samples without replacement: the mega cohort is capped at
    # the client population (and kept a multiple of the chunk)
    mega = min(args.mega_cohort, ds.num_clients)
    mega -= mega % min(args.cohort_chunk, mega)

    # ---- part 1: aggregation topologies --------------------------------
    topologies = [
        ("flat dense", comm.DenseChannel()),
        (f"{args.edges} edges, int8 uplink", hierarchy.HierarchicalChannel(
            args.edges, client_channel=comm.QuantizedChannel(8))),
        (f"{args.edges} edges, outage p={args.edge_dropout}",
         hierarchy.HierarchicalChannel(
             args.edges, client_channel=comm.QuantizedChannel(8),
             edge_channel=comm.DropoutChannel(args.edge_dropout))),
    ]
    rows = {}
    print(f"{'topology':>28s} {'loss':>9s} {'probe':>6s} "
          f"{'client->edge MB':>16s} {'edge->server MB':>16s}")
    for name, ch in topologies:
        opt = opt_lib.adam(2e-3)
        ecfg = round_engine.EngineConfig(
            algorithm="dcco", lam=5.0,
            chunk_rounds=min(args.rounds, 25), channel=ch)
        eng = round_engine.RoundEngine(s.apply, opt, sampler, ecfg)
        p, _, m = eng.run(params0, opt.init(params0), 7, args.rounds)
        total_mb = float(m.wire_bytes.sum()) / 1e6
        if isinstance(ch, hierarchy.HierarchicalChannel):
            # per-hop split of the measured total from the static payload
            # widths: K client payloads vs E edge payloads per phase (an
            # edge outage shrinks both hops by the same survival factor,
            # so the split is participation-independent)
            tmpl = {"x": torch.zeros((64,))}
            cb = args.clients_per_round * \
                ch.client_channel.payload_bytes(tmpl)
            eb = args.edges * ch.edge_channel.payload_bytes(tmpl)
            frac_c = cb / (cb + eb)
            mb_c, mb_e = total_mb * frac_c, total_mb * (1 - frac_c)
        else:
            mb_c, mb_e = total_mb, 0.0
        acc = s.probe(p)
        rows[name] = {"losses": m.loss.cpu().tolist(), "probe": acc,
                      "client_edge_mb": mb_c, "edge_server_mb": mb_e}
        print(f"{name:>28s} {float(m.loss[-1]):9.3f} {acc:6.3f} "
              f"{mb_c:16.2f} {mb_e:16.2f}", flush=True)

    # exactness: a dense-dense tree IS flat aggregation, bit for bit
    opt = opt_lib.adam(2e-3)
    flat = round_engine.RoundEngine(
        s.apply, opt, sampler,
        round_engine.EngineConfig(algorithm="dcco", lam=5.0, chunk_rounds=3))
    tree = round_engine.RoundEngine(
        s.apply, opt, sampler,
        round_engine.EngineConfig(algorithm="dcco", lam=5.0, chunk_rounds=3,
                                  channel=hierarchy.HierarchicalChannel(
                                      args.edges)))
    pf, _, _ = flat.run(params0, opt.init(params0), 9, 3)
    pt, _, _ = tree.run(params0, opt.init(params0), 9, 3)
    diff = utils.tree_max_abs_diff(pf, pt)
    print(f"dense two-level tree vs flat aggregation: max|diff| = {diff} "
          f"(Eq. 3 exactness)")

    # ---- part 2: streaming mega-cohort ---------------------------------
    print(f"\nstreaming {mega} clients/round in chunks of "
          f"{args.cohort_chunk} (peak batch memory O(chunk)):")

    def chunk_aligned(cohort):
        """Largest chunk-multiple cohort <= ``cohort`` (>= one chunk)."""
        chunk = min(args.cohort_chunk, cohort)
        return max(cohort - cohort % chunk, chunk)

    streamed = {}
    for cohort in dict.fromkeys((chunk_aligned(min(64, mega)), mega)):
        opt = opt_lib.adam(2e-3)
        chunk = min(args.cohort_chunk, cohort)
        ecfg = round_engine.EngineConfig(algorithm="dcco", lam=5.0,
                                         chunk_rounds=1, cohort_chunk=chunk)
        eng = round_engine.RoundEngine(
            s.apply, opt, ds.make_streaming_sampler(cohort, chunk, device),
            ecfg)
        t0 = time.perf_counter()
        p, _, m = eng.run(params0, opt.init(params0), 7, 1)
        _common.sync(device)
        secs = time.perf_counter() - t0
        streamed[cohort] = float(m.loss[-1])
        print(f"  cohort {cohort:5d}: loss={float(m.loss[-1]):8.3f} "
              f"round_time={secs:6.2f}s "
              f"(incl. first-call setup)", flush=True)
    return {"rows": rows, "tree_vs_flat": diff, "streamed": streamed}


if __name__ == "__main__":
    main()
