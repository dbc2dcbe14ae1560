"""The port's nine examples (``repro_torch.examples``) on the CPU, at the
"CI smoke" arguments of the reference scripts' docstrings (``--rounds 3
--dataset-size 120``; federated_hierarchy also ``--mega-cohort 64``), or
at small sizes where a script gives none: each runs through
``main([... "--device", "cpu"])``, and its losses and figures are finite
and in range, with the reference's wire figures (payload bytes, the DP
epsilon) where the example prints them.

The quickstart also runs on the reference's own inputs: the reference's
initial parameters (``repro_torch.convert.params_from_jax``), its
Appendix-A round batch, which the engine's first round also takes (its
D-CCO loss is the reference's D-CCO round's on that batch). Tolerances,
those of tests/test_torch_round.py (a protocol fault moves parameters by
O(1) of the update):

  * the Appendix-A ratio |fed - centralized| / |update|: the reference's
    (f32) and the port's in f64 below 1e-4, that file's Appendix-A bound
    (read 1.1e-5 and 1.2e-5: the identity holds to that level, not to
    rounding, in both); the port's in f32 below 1e-3, that file's bound
    on one round's parameters against the reference (read 2.0e-4: at
    the smoke config's 8 GroupNorm groups of 2 channels the f32 gradient
    is ill-conditioned, as that file's docstring measures);
  * the first engine round's loss to rtol 1e-3, that file's tolerance on
    engine rounds' losses: the port's engine takes the phase-1 aggregate
    on the flattened cohort, the reference's the per-client average, and
    the smoke config's f32 forward is ill-conditioned (on one cohort the
    f64 loss read 69.2255, the port's f32 69.2308 and the reference's
    69.2206).
"""
import contextlib
import importlib
import io
import math

import jax
import numpy as np
import pytest
import torch

from repro import comm as j_comm
from repro import objectives as j_objectives
from repro.configs.base import DualEncoderConfig as JDE
from repro.configs.base import get_config as j_get_config
from repro.core import fed_sim as j_fed_sim
from repro.data import pipeline as j_pipeline
from repro.data import synthetic as j_synthetic
from repro.models import dual_encoder as j_de
from repro.optim import optimizers as j_opt
from repro_torch import convert, utils
from repro_torch.configs.base import DualEncoderConfig, get_config
from repro_torch.examples import _common, quickstart

torch.set_num_threads(1)

SMOKE = ["--rounds", "3", "--dataset-size", "120"]
EXAMPLES = {
    "quickstart": SMOKE,
    "federated_cifar": ["--rounds", "2", "--dataset-size", "64"],
    "federated_vicreg": SMOKE,
    "federated_comm": SMOKE,
    "federated_noniid": SMOKE,
    "federated_hierarchy": SMOKE + ["--mega-cohort", "64"],
    "federated_async": SMOKE,
    "dual_encoder_text": ["--rounds", "3", "--dataset-size", "64"],
    "serve_retrieval": ["--docs", "64", "--queries", "8"],
}


def _finite(xs):
    return all(math.isfinite(x) for x in xs)


def _prob(x):
    return 0.0 <= x <= 1.0


def _check_quickstart(out, printed):
    assert out["appendix_a"] < 1e-4
    assert len(out["losses"]) == 3 and _finite(out["losses"])
    assert _prob(out["probe_init"]) and _prob(out["probe"])
    assert "equivalence check" in printed


def _check_cifar(out, printed):
    table = out["table"]
    # FedAvg+CCO needs >= 2 samples a client: refused on the s=1 split
    assert ("non-IID s=1", "cco_fedavg") not in table
    assert "FAILED(n<2)" in printed
    assert len(table) == 11
    for acc, losses in table.values():
        assert _prob(acc) and len(losses) == 2 and _finite(losses)


def _check_vicreg(out, printed):
    for name, row in out["rows"].items():
        obj = j_objectives.get_objective(
            name, **({"lam": 5.0} if name == "dcco" else {}))
        # the reference's stats count and int8 payload bytes
        assert row["stats"] == len(obj.stat_keys)
        assert row["payload_bytes"] == j_comm.get_channel(
            "int8").payload_bytes(obj.stat_template(64))
        assert _finite(row["losses"]) and _prob(row["probe"])
        assert row["uplink_mb"] > 0


def _check_comm(out, printed):
    rows = out["rows"]
    for row in rows.values():
        assert _finite(row["losses"]) and _prob(row["probe"])
        assert row["uplink_mb"] > 0
    assert rows["int8 quantized"]["uplink_mb"] < \
        rows["dense (ideal)"]["uplink_mb"]
    ref = j_comm.DPGaussianChannel(0.3, clip_norm=10.0)
    ref.finalize_rounds(3)
    eps = rows["DP sigma=0.3"]["epsilon"]
    assert eps == pytest.approx(ref.accountant.epsilon(), rel=1e-12)
    assert math.isinf(rows["dense (ideal)"]["epsilon"])


def _check_noniid(out, printed):
    assert len(out["rows"]) == 4
    for row in out["rows"].values():
        assert _finite(row["losses"]) and _prob(row["probe"])
    assert "60 single-class 2-sample clients" in printed


def _check_hierarchy(out, printed):
    assert out["tree_vs_flat"] == 0.0
    for name, row in out["rows"].items():
        assert _finite(row["losses"]) and _prob(row["probe"])
        if "edges" in name:
            assert row["client_edge_mb"] > row["edge_server_mb"] > 0
    assert list(out["streamed"]) == [32] and _finite(out["streamed"].values())


def _check_async(out, printed):
    assert out["buffered_vs_sync"] == 0.0
    rows = out["rows"]
    assert out["sync_ticks"] >= 3
    for name, row in rows.items():
        assert _finite(row["losses"]) and _prob(row["probe"])
        assert 1 <= row["updates"] <= 3
    assert set(rows) == {"sync", "buffered K=4", "buffered K=8"}


def _check_text(out, printed):
    assert len(out["losses"]) == 3 and _finite(out["losses"])
    assert _prob(out["probe_init"]) and _prob(out["probe"])


def _check_serve(out, printed):
    assert all(_prob(v) for v in out["metrics"].values())
    assert _prob(out["ivf_overlap"])
    assert out["stats"]["queries"] == 8
    assert out["refresh"]["blocks_refreshed"] >= 0
    gen = out["generated"]
    assert gen.shape == (4, 8) and gen.dtype == torch.int32
    assert bool(((gen >= 0) & (gen < 512)).all())
    assert "top-10 bitwise == flat index" in printed


CHECKS = {"quickstart": _check_quickstart, "federated_cifar": _check_cifar,
          "federated_vicreg": _check_vicreg, "federated_comm": _check_comm,
          "federated_noniid": _check_noniid,
          "federated_hierarchy": _check_hierarchy,
          "federated_async": _check_async,
          "dual_encoder_text": _check_text,
          "serve_retrieval": _check_serve}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs_on_cpu(name):
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = mod.main([*EXAMPLES[name], "--device", "cpu"])
    printed = buf.getvalue()
    assert printed.strip()
    CHECKS[name](out, printed)


def test_examples_refuse_without_a_gpu_and_run_nothing_at_import(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in EXAMPLES:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        with pytest.raises(RuntimeError):
            mod.main(EXAMPLES[name])


def test_quickstart_on_the_references_inputs():
    jcfg = j_get_config("resnet14-cifar", smoke=True)
    jde = JDE(proj_dims=(64, 64), lambda_cco=5.0)
    jp = jax.jit(j_de.init_dual_encoder, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jcfg, jde)
    imgs, labels = j_synthetic.synthetic_labeled_images(
        600, 5, image_size=16, noise=0.5, seed=1)
    ds = j_pipeline.FederatedDataset.build(
        {"images": imgs}, labels, num_clients=128, samples_per_client=2,
        alpha=0.0, seed=0)

    def j_apply(p, batch):
        zf, _ = j_de.encode(jcfg, jde, p, {"images": batch["v1"]})
        zg, _ = j_de.encode(jcfg, jde, p, {"images": batch["v2"]})
        return zf, zg

    # step 3, the reference's Appendix-A check on its round batch, whose
    # D-CCO round also gives the loss that the engine's first round on
    # that batch must reproduce
    batch, sizes = ds.round_batch(jax.random.PRNGKey(42), 16)
    opt = j_opt.sgd(0.05)

    @jax.jit
    def j_steps(p, b, sz):
        p_fed, _, m = j_fed_sim.dcco_round(j_apply, p, opt.init(p), opt, b,
                                           sz, lam=5.0, client_lr=1.0)
        union = jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]), b)
        p_cent, _, _ = j_fed_sim.centralized_step(j_apply, p, opt.init(p),
                                                  opt, union, lam=5.0)
        return p_fed, p_cent, m.loss

    p_fed, p_cent, loss_j = j_steps(jp, batch, sizes)
    ratio_j = (max(float(np.max(np.abs(a - b))) for a, b in
                   zip(jax.tree.leaves(p_fed), jax.tree.leaves(p_cent)))
               / max(float(np.max(np.abs(a - b))) for a, b in
                     zip(jax.tree.leaves(p_fed), jax.tree.leaves(jp))))

    def to_torch(tree):
        return utils.tree_map(lambda x: torch.tensor(np.asarray(x)), tree)

    def f64(tree):
        return utils.tree_map(lambda x: x.double(), tree)

    p0 = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    t_apply = _common.two_view_apply(
        get_config("resnet14-cifar", smoke=True),
        DualEncoderConfig(proj_dims=(64, 64), lambda_cco=5.0))
    tb, tsz = to_torch(batch), torch.tensor(np.asarray(sizes))
    ratio_t = quickstart.appendix_a_ratio(t_apply, p0, tb, tsz)
    ratio_64 = quickstart.appendix_a_ratio(t_apply, f64(p0), f64(tb), tsz)
    assert ratio_j < 1e-4 and ratio_64 < 1e-4, (ratio_j, ratio_64)
    assert ratio_t < 1e-3, ratio_t

    # step 4's first round through the quickstart's engine, on that batch
    eng, opt_t = quickstart.make_engine(t_apply, lambda gen: (tb, tsz))
    _, _, mt = eng.run(p0, opt_t.init(p0), 100, 1)
    np.testing.assert_allclose(mt.loss.numpy(), [float(loss_j)], rtol=1e-3)
