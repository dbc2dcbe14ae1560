#!/usr/bin/env python3
"""Find the client learning rate at which a training path's losses stay
finite: run ``repro_torch.launch.train`` with ``--client-lr`` set to
``--start-lr`` (1.0, the CLI's default, unless given), then half, a
quarter, ... until every round's loss and every parameter is finite, or
the rate falls below 2^-30.

  python3 tools/halve_client_lr.py [--algorithm A] [--start-lr X] -- \\
      --full --rounds 3 --local-steps 2 --scaffold --seed 1 ...

Everything after ``--`` goes to the training CLI as it is (without a
``--client-lr``). Each attempt prints one line: the rate, the losses, and
whether the run was finite; the last line is the first finite rate, as
JSON. Started at the rate a path already uses, the first attempt checks
that rate. ``chip_smoke.py`` takes the rates of its paths with more than
one local step from this script's runs on the card (PERF.md). Runs on the
GPU unless ``--device cpu`` is among the training flags.
"""
import argparse
import gc
import json
import math
from pathlib import Path
import sys

ROOT = Path(__file__).resolve().parents[1]
MIN_LR = 2.0 ** -30


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if "--" not in argv:
        raise SystemExit("training flags go after --")
    cut = argv.index("--")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--algorithm", default="dcco")
    ap.add_argument("--start-lr", type=float, default=1.0)
    args = ap.parse_args(argv[:cut])
    flags = argv[cut + 1:]
    if "--client-lr" in flags:
        raise SystemExit("this script sets --client-lr itself")
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch import utils
    from repro_torch.launch import train

    lr = args.start_lr
    while lr >= MIN_LR:
        res = train.run(train.parse_args([*flags, "--client-lr", repr(lr)]),
                        algorithm=args.algorithm)
        finite = res["loss_finite"] and all(
            bool(torch.isfinite(x).all())
            for x in utils.tree_leaves(res["params"]))
        print(f"client lr {lr!r} (2^{int(math.log2(lr))}): losses "
              f"{res['history']}, finite {finite}", flush=True)
        del res
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        if finite:
            print(json.dumps({"algorithm": args.algorithm, "flags": flags,
                              "client_lr": lr}), flush=True)
            return lr
        lr /= 2
    raise SystemExit(f"no finite run down to --client-lr {MIN_LR}")


if __name__ == "__main__":
    main()
