"""What the ResNet examples share, as each reference script builds it:
the smoke WS+GN ResNet-14 dual encoder (projection 64, 64; lambda 5)
from seed 0, its synthetic labeled images, the two-view apply, the
label-sharded federated dataset and the ridge linear probe."""
from __future__ import annotations

import argparse
from typing import NamedTuple

import torch

from repro_torch.configs.base import DualEncoderConfig, get_config
from repro_torch.core import eval as eval_lib
from repro_torch.data import partition, pipeline, synthetic
from repro_torch.models import dual_encoder, resnet
from repro_torch.utils import resolve_device


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; without a GPU only "
                         "--device cpu runs")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def two_view_apply(cfg, de, leaf: str = "images"):
    def apply(p, batch):
        zf, _ = dual_encoder.encode(cfg, de, p, {leaf: batch["v1"]})
        zg, _ = dual_encoder.encode(cfg, de, p, {leaf: batch["v2"]})
        return zf, zg
    return apply


def label_sharded(data, labels, *, num_clients: int,
                  samples_per_client: int, alpha: float = 0.0):
    """``FederatedDataset.build`` at the reference scripts' ``alpha=``:
    alpha 0 gives single-class clients (the paper's hard split), alpha
    >= 1e6 IID ones."""
    return pipeline.FederatedDataset.build(
        data, labels, num_clients=num_clients,
        samples_per_client=samples_per_client,
        partition=partition.PartitionSpec("dirichlet", alpha=alpha), seed=0)


class ResnetSetup(NamedTuple):
    device: torch.device
    cfg: object
    de: DualEncoderConfig
    params0: dict
    imgs: object            # (N, H, W, C) f32 numpy
    labels: object          # (N,) int numpy
    classes: int
    apply: object

    def probe(self, p, cut=None) -> float:
        """Ridge linear-probe accuracy of the tower's encodings: fit on
        the first ``cut`` images (default 70%), score the rest."""
        cut = int(len(self.labels) * 0.7) if cut is None else cut
        y = torch.as_tensor(self.labels, device=self.device)
        with torch.no_grad():
            z = resnet.resnet_forward(
                self.cfg, p["tower"],
                torch.as_tensor(self.imgs, device=self.device))
            return float(eval_lib.ridge_linear_probe(
                z[:cut], y[:cut], z[cut:], y[cut:], self.classes))


def resnet_setup(args, noise: float = 0.5) -> ResnetSetup:
    """The scripts' common prologue from ``args.device``,
    ``args.dataset_size`` and ``args.classes``."""
    device = resolve_device(args.device)
    cfg = get_config("resnet14-cifar", smoke=True)
    de = DualEncoderConfig(proj_dims=(64, 64), lambda_cco=5.0)
    params0 = dual_encoder.init_dual_encoder(0, cfg, de, device)
    imgs, labels = synthetic.synthetic_labeled_images(
        args.dataset_size, args.classes, image_size=cfg.image_size,
        noise=noise, seed=1)
    return ResnetSetup(device, cfg, de, params0, imgs, labels, args.classes,
                       two_view_apply(cfg, de))
