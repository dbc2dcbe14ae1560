"""Where two plain-GD local steps of D-CCO first stay finite, against the
ResNet's width, in both packages, on the CPU.

At each width of :data:`WIDTHS` (the smoke ResNet with its channels, its
final width and its projection head scaled together; then the paper's
channels at the smoke depth, and the paper's config), the reference's
and the port's D-CCO round with FedProx (mu 0.01) or with SCAFFOLD (zero
variates), two local steps, lam 5 and the CLI's server Adam(2e-3), run
up to ROUNDS rounds on one reference-drawn cohort of K clients of 2
images (the CLI's fully non-IID Dirichlet partition), from one start
drawn by the reference and converted. The client lr halves from
``start`` (1.0, as ``tools/halve_client_lr.py`` starts) until the rounds
leave the loss, the parameters and the variates finite; a run stops at
its first non-finite round.

  PYTHONPATH=src python tests/_torch_lr_width.py [--widths smoke,x2,...]

prints one line a width, algorithm and package, and a JSON table last.
"""
import argparse
import json
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import DualEncoderConfig as JDE
from repro.configs.base import get_config as j_get_config
from repro.core import cco as j_cco
from repro.core import fed_sim as j_fed_sim
from repro.data import partition as j_partition
from repro.data import pipeline as j_pipeline
from repro.data import synthetic as j_synthetic
from repro.models import dual_encoder as j_de
from repro.optim import optimizers as j_opt
from repro.server import drift as j_drift
from repro_torch import convert, utils
from repro_torch.configs.base import DualEncoderConfig, get_config
from repro_torch.core import cco, fed_sim
from repro_torch.launch.train import make_apply
from repro_torch.optim import optimizers as opt_lib
from repro_torch.server import drift

# name: (ResNet config overrides of the smoke config, or None for the
# paper's config, projection head)
WIDTHS = {
    "smoke": ({}, (64, 64)),
    "x2": ({"resnet_channels": (32, 64), "d_model": 64}, (128, 128)),
    "x4": ({"resnet_channels": (64, 128), "d_model": 128}, (256, 256)),
    "x8": ({"resnet_channels": (128, 256), "d_model": 256}, (512, 512)),
    "paper channels": ({"resnet_channels": (64, 128, 256), "d_model": 256,
                        "resnet_stages": (1, 1, 1)}, (1024, 1024, 1024)),
    "paper": (None, (1024, 1024, 1024)),
}
ALGOS = {"fedprox": {"prox_mu": 0.01}, "scaffold": {}}
ROUNDS, K, LAM, SERVER_LR = 3, 16, 5.0, 2e-3
MIN_LR = 2.0 ** -30


def setup(width: str):
    """Both packages' encoders at ``width``, the reference's start and
    its cohort."""
    kw, proj = WIDTHS[width]
    smoke = kw is not None
    jcfg = j_get_config("resnet14-cifar", smoke=smoke).replace(**(kw or {}))
    tcfg = get_config("resnet14-cifar", smoke=smoke).replace(**(kw or {}))
    jde, tde = JDE(proj_dims=proj, lambda_cco=LAM), DualEncoderConfig(
        proj_dims=proj, lambda_cco=LAM)
    jp = jax.jit(j_de.init_dual_encoder, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jcfg, jde)
    imgs, labels = j_synthetic.synthetic_labeled_images(
        4 * K, 8, image_size=jcfg.image_size, noise=0.5, seed=1)
    ds = j_pipeline.FederatedDataset.build(
        {"images": imgs}, labels, num_clients=2 * K, samples_per_client=2,
        partition=j_partition.PartitionSpec("dirichlet", alpha=0.0),
        seed=0)
    batch, sizes = ds.round_batch(jax.random.PRNGKey(42), K)

    def j_apply(p, b):
        zf, _ = j_de.encode(jcfg, jde, p, {"images": b["v1"]})
        zg, _ = j_de.encode(jcfg, jde, p, {"images": b["v2"]})
        return zf, zg

    return {"j_apply": j_apply, "t_apply": make_apply(tcfg, tde),
            "jp": jp, "batch": batch, "sizes": sizes}


def _finite_j(tree) -> bool:
    return all(bool(jnp.isfinite(x).all()) for x in jax.tree.leaves(tree))


def _finite_t(tree) -> bool:
    return all(bool(torch.isfinite(x).all()) for x in utils.tree_leaves(tree))


def reference_runner(s, algo: str):
    """``run(lr) -> rounds finite`` (ROUNDS when every round is) of the
    reference's rounds, jitted (a compile a rate: the round reads the
    rate as a Python float)."""
    opt = j_opt.adam(SERVER_LR)
    scaffold = algo == "scaffold"
    fn = jax.jit(lambda p, o, b, z, d, lr: j_fed_sim.dcco_round(
        s["j_apply"], p, o, opt, b, z, lam=LAM, client_lr=lr,
        local_steps=2, scaffold_state=d, **ALGOS[algo]),
        static_argnums=5)

    def run(lr, log=None):
        p, o = s["jp"], opt.init(s["jp"])
        d = j_drift.scaffold_init(p, K) if scaffold else None
        for r in range(ROUNDS):
            out = fn(p, o, s["batch"], s["sizes"], d, lr)
            p, o, m = out[0], out[1], out[-1]
            d = out[2] if scaffold else None
            if log is not None:
                log.append([float(m.loss)] + [
                    max([float(jnp.abs(x).max()) for x in jax.tree.leaves(t)]
                        or [0.0]) for t in (p, d)])
            if not (math.isfinite(float(m.loss)) and _finite_j((p, d))):
                return r
        return ROUNDS

    return run


def port_runner(s, algo: str):
    """``run(lr) -> rounds finite`` of the port's rounds."""
    opt = opt_lib.adam(SERVER_LR)
    scaffold = algo == "scaffold"
    p0 = convert.params_from_jax(jax.tree.map(np.asarray, s["jp"]))
    batch = utils.tree_map(lambda x: torch.tensor(np.asarray(x)),
                           s["batch"])
    sizes = torch.tensor(np.asarray(s["sizes"]))

    def run(lr, log=None):
        p, o = p0, opt.init(p0)
        d = drift.scaffold_init(p, K) if scaffold else None
        for r in range(ROUNDS):
            out = fed_sim.dcco_round(
                s["t_apply"], p, o, opt, batch, sizes, lam=LAM,
                client_lr=lr, local_steps=2, scaffold_state=d,
                **ALGOS[algo])
            p, o, m = out[0], out[1], out[-1]
            d = out[2] if scaffold else None
            if log is not None:
                log.append([m.loss.item()] + [
                    max([x.abs().max().item() for x in utils.tree_leaves(t)]
                        or [0.0]) for t in (p, () if d is None else (d.c, d.c_slots))])
            state = (p, d.c, d.c_slots) if scaffold else p
            if not (math.isfinite(m.loss.item()) and _finite_t(state)):
                return r
        return ROUNDS

    return run


def start_losses(s, width: str) -> dict:
    """The CCO loss of the whole cohort's encodings at the start (the
    round's first statistics): the reference's in f32 and the port's in
    f32 and in f64, to tell a port fault from f32 rounding."""
    flat = jax.tree.map(lambda x: np.asarray(x).reshape(
        (-1,) + np.shape(x)[2:]), s["batch"])
    zf, zg = jax.jit(s["j_apply"])(s["jp"], flat)
    out = {"reference_f32": float(j_cco.cco_loss(zf, zg, LAM))}
    kw, proj = WIDTHS[width]
    p0 = convert.params_from_jax(jax.tree.map(np.asarray, s["jp"]))
    batch = utils.tree_map(torch.from_numpy, flat)
    for name, dtype in (("port_f32", torch.float32),
                        ("port_f64", torch.float64)):
        cfg = get_config("resnet14-cifar", smoke=kw is not None).replace(
            **(kw or {}), dtype=str(dtype).split(".")[-1])
        apply = make_apply(cfg, DualEncoderConfig(proj_dims=proj,
                                                  lambda_cco=LAM))
        with torch.no_grad():
            zf, zg = apply(utils.tree_map(lambda x: x.to(dtype), p0),
                           utils.tree_map(lambda x: x.to(dtype), batch))
            out[name] = cco.cco_loss(zf, zg, LAM).item()
    return out


def first_finite(run, start: float = 1.0):
    """The first rate, halving from ``start``, at which ``run`` stays
    finite for ROUNDS rounds; and each tried rate's finite rounds."""
    lr, tried = start, []
    while lr >= MIN_LR:
        rounds = run(lr)
        tried.append((lr, rounds))
        if rounds == ROUNDS:
            return lr, tried
        lr /= 2
    return None, tried


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--widths", default=",".join(WIDTHS))
    ap.add_argument("--start", type=float, default=1.0)
    ap.add_argument("--trace", default=None, metavar="ALGO:EXPONENT",
                    help="print each package's loss, max |parameter| "
                         "and max |variate| after each round at client lr "
                         "2^EXPONENT, for each width, and no search")
    ap.add_argument("--start-loss", action="store_true",
                    help="print the cohort's CCO loss at the start, the "
                         "reference's in f32 and the port's in f32 and "
                         "f64, for each width, and no search")
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    if args.start_loss:
        for width in args.widths.split(","):
            print(width, json.dumps(start_losses(setup(width), width)),
                  flush=True)
        return
    if args.trace:
        algo, exp = args.trace.split(":")
        for width in args.widths.split(","):
            s = setup(width)
            for name, make in (("reference", reference_runner),
                               ("port", port_runner)):
                log = []
                rounds = make(s, algo)(2.0 ** int(exp), log)
                rows = [tuple(float(f"{x:.6g}") for x in r) for r in log]
                print(f"{width} {algo} {name} at 2^{exp}: finite rounds "
                      f"{rounds}; (loss, max |parameter|, max |variate|) a "
                      f"round {rows}", flush=True)
        return
    table = {}
    for width in args.widths.split(","):
        s = setup(width)
        for algo in ALGOS:
            for name, make in (("reference", reference_runner),
                               ("port", port_runner)):
                t0 = time.perf_counter()
                lr, tried = first_finite(make(s, algo), args.start)
                table[f"{width}/{algo}/{name}"] = lr
                print(f"{width} {algo} {name}: first finite client lr "
                      f"{lr!r} (2^{int(math.log2(lr)) if lr else None}); "
                      f"finite rounds by rate "
                      f"{[(int(math.log2(x)), n) for x, n in tried]}; "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(table))


if __name__ == "__main__":
    main()
