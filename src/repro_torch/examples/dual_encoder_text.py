"""Federated DCCO pretraining of a *transformer* dual encoder on token
sequences — the same protocol as the paper but with an assigned LLM backbone
(tinyllama family, reduced) and token-level two-view augmentations.

Demonstrates: token augmentations, the fused train step (one step == one
federated round), and the exact-microbatching path.

Run: PYTHONPATH=src python -m repro_torch.examples.dual_encoder_text
     [--device cpu] (CI smoke: --rounds 3 --dataset-size 64)
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import utils
from repro_torch.configs.base import DualEncoderConfig, TrainConfig, get_config
from repro_torch.core import eval as eval_lib
from repro_torch.data import synthetic
from repro_torch.examples import _common
from repro_torch.launch import steps as steps_lib
from repro_torch.models import dual_encoder, transformer
from repro_torch.optim import optimizers as opt_lib
from repro_torch.utils import resolve_device

ARCH = "tinyllama-1.1b"
SEQ, CPR, SPC = 32, 16, 1   # 16 single-sample clients per round (paper's
                            # hardest setting — impossible for FedAvg+CCO)
CLASSES = 4


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--dataset-size", type=int, default=400,
                    help="token sequences, one client each")
    _common.add_device_flag(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(ARCH, smoke=True)
    de = DualEncoderConfig(proj_dims=(64, 64), lambda_cco=5.0)
    params = dual_encoder.init_dual_encoder(0, cfg, de, device)

    toks, labels = synthetic.synthetic_labeled_tokens(
        args.dataset_size, CLASSES, SEQ, vocab=cfg.vocab_size, seed=0)
    ds = _common.label_sharded({"tokens": toks}, labels,
                               num_clients=args.dataset_size,
                               samples_per_client=SPC)

    tcfg = TrainConfig(global_batch=CPR * SPC, samples_per_client=SPC,
                       dcco_impl="fused")
    opt = opt_lib.adam(2e-3)
    # exact DCCO microbatching (stats pass + grad pass) — 2 microbatches
    step = steps_lib.make_dcco_train_step(cfg, de, tcfg, opt,
                                          num_microbatches=2)
    state = opt.init(params)
    toks_t = torch.as_tensor(toks, device=device)
    labels_t = torch.as_tensor(labels, device=device)
    # the reference fits the probe on 300 of its 400 sequences
    cut = args.dataset_size * 3 // 4

    def probe(p):
        with torch.no_grad():
            h = transformer.forward(cfg, p["tower"], toks_t)
            z = h.to(torch.float32).mean(dim=1)
            return float(eval_lib.ridge_linear_probe(
                z[:cut], labels_t[:cut], z[cut:], labels_t[cut:], CLASSES))

    probe0 = probe(params)
    print(f"random-init probe: {probe0:.3f}")
    losses = []
    for r in range(args.rounds):
        flat, _ = ds.flat_round_batch(utils.generator(100 + r, device), CPR,
                                      device)
        batch = {"view1": {"tokens": flat["v1"]},
                 "view2": {"tokens": flat["v2"]}}
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        if (r + 1) % 10 == 0:
            print(f"round {r + 1:3d}  loss={float(m['loss']):8.3f}  "
                  f"enc_std={float(m['encoding_std']):.3f}")
    probe1 = probe(params)
    print(f"post-pretraining probe: {probe1:.3f}")
    return {"losses": losses, "probe_init": probe0, "probe": probe1}


if __name__ == "__main__":
    main()
