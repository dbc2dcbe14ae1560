"""Quickstart: federated DCCO on synthetic non-IID clients.

Shows the whole public API surface: config -> dual encoder -> federated
dataset -> DCCO rounds through the round engine
(repro_torch.core.round_engine) -> linear-probe evaluation, plus the
Appendix-A equivalence check against a centralized step.

Run: PYTHONPATH=src python -m repro_torch.examples.quickstart
     [--device cpu] (CI smoke: --rounds 3 --dataset-size 120)
"""
from __future__ import annotations

import argparse

from repro_torch import utils
from repro_torch.core import fed_sim, round_engine
from repro_torch.examples import _common
from repro_torch.optim import optimizers as opt_lib

LAM = 5.0
COHORT = 16


def appendix_a_ratio(apply, params, batch, sizes) -> float:
    """|fed - centralized| / |update| of one DCCO round (one local step
    at client lr 1, server SGD 0.05) against one centralized step on the
    cohort's union. Relative, as the weight-standardized stem has
    ~1e4-magnitude gradients: absolute differences reflect f32
    conditioning, not protocol error."""
    opt = opt_lib.sgd(0.05)
    p_fed, _, _ = fed_sim.dcco_round(apply, params, opt.init(params), opt,
                                     batch, sizes, lam=LAM, client_lr=1.0)
    union = utils.tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])),
                           batch)
    p_cent, _, _ = fed_sim.centralized_step(apply, params, opt.init(params),
                                            opt, union, lam=LAM)
    return (utils.tree_max_abs_diff(p_fed, p_cent)
            / utils.tree_max_abs_diff(p_fed, params))


def make_engine(apply, sampler):
    """The engine of step 4: Adam 2e-3, DCCO, segments of 10 rounds."""
    opt = opt_lib.adam(2e-3)
    ecfg = round_engine.EngineConfig(algorithm="dcco", lam=LAM,
                                     chunk_rounds=10)
    return round_engine.RoundEngine(apply, opt, sampler, ecfg), opt


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--dataset-size", type=int, default=600)
    _common.add_device_flag(ap)
    args = ap.parse_args(argv)
    args.classes = 5

    # 1. model: the paper's WS+GN ResNet dual encoder (reduced)
    # 2. data: synthetic labeled images, Dirichlet(alpha=0) => single-class
    #    clients with 2 samples each (the paper's hard setting)
    s = _common.resnet_setup(args)
    params, device = s.params0, s.device
    ds = _common.label_sharded({"images": s.imgs}, s.labels,
                               num_clients=min(128, args.dataset_size // 2),
                               samples_per_client=2)
    # the reference fits the probe on 400 of its 600 images
    cut = args.dataset_size * 2 // 3
    probe0 = s.probe(params, cut)
    print(f"random-init probe accuracy: {probe0:.3f}")

    # 3. sanity: one DCCO round == one centralized step (Appendix A)
    batch, sizes = ds.round_batch(utils.generator(42, device), COHORT,
                                  device)
    ratio = appendix_a_ratio(s.apply, params, batch, sizes)
    del batch, sizes
    print(f"equivalence check: |fed - centralized| / |update| = {ratio:.2e}")

    # 4. train federated rounds with the engine: client sampling,
    #    augmentation and the rounds of a segment run on the device; the
    #    per-round metrics come back a 10-round segment at a time
    engine, opt = make_engine(s.apply,
                              ds.make_round_sampler(COHORT, device))
    losses = []

    def report(round_end, carry, m):
        losses.extend(float(x) for x in m.loss.cpu())
        print(f"round {round_end:3d}  loss={float(m.loss[-1]):8.3f}  "
              f"enc_std={float(m.encoding_std[-1]):.3f}")

    params, _, _ = engine.run(params, opt.init(params), 100, args.rounds,
                              on_segment=report)
    probe = s.probe(params, cut)
    print(f"post-pretraining probe accuracy: {probe:.3f}")
    return {"appendix_a": ratio, "losses": losses, "probe_init": probe0,
            "probe": probe, "params": params}


if __name__ == "__main__":
    main()
