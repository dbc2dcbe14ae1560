"""Port vs reference: synthetic data (bit-equal), every partition strategy
(index for index, errors included), and image augmentation given the
reference's own random draws (threefry and Philox never agree, so draws
are carried across, never reseeded). The pipeline's sampler is checked
inside the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import augment as j_augment
from repro.data import partition as j_partition
from repro.data import pipeline as j_pipeline
from repro.data import synthetic as j_synthetic
from repro_torch.data import augment, partition, pipeline, synthetic

# tier-1 runs 6 pytest workers on the machine's cores: one torch thread
# per worker keeps them from contending with each other and with JAX
torch.set_num_threads(1)


def test_synthetic_images_bit_equal():
    for n, c, size, seed in [(50, 5, 16, 0), (17, 3, 8, 4)]:
        ri, rl = j_synthetic.synthetic_labeled_images(n, c, image_size=size,
                                                      noise=0.5, seed=seed)
        pi, pl = synthetic.synthetic_labeled_images(n, c, image_size=size,
                                                    noise=0.5, seed=seed)
        assert pi.dtype == ri.dtype and pl.dtype == rl.dtype
        np.testing.assert_array_equal(pi, ri)
        np.testing.assert_array_equal(pl, rl)


def _spec_pair(strategy, severity=None, alpha=None):
    kw = {} if alpha is not None else {"severity": severity}
    if alpha is not None:
        kw["alpha"] = alpha
    return (j_partition.PartitionSpec(strategy, **kw),
            partition.PartitionSpec(strategy, **kw))


@pytest.mark.parametrize("strategy,severity,alpha", [
    ("iid", 0.5, None), ("uniform", 0.0, None), ("label", 0.0, None),
    ("label", 0.6, None), ("label", 1.0, None), ("dirichlet", 0.0, None),
    ("dirichlet", 0.5, None), ("dirichlet", 0.9, None),
    ("dirichlet", None, 0.0), ("dirichlet", None, 1e6),
    ("dirichlet_quantity", 0.3, None), ("dirichlet_quantity", 1.0, None),
])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_partitions_index_for_index(strategy, severity, alpha, seed):
    labels = np.random.RandomState(100 + seed).randint(0, 6, 240)
    js, ps = _spec_pair(strategy, severity, alpha)
    ji, jsz = j_partition.build_partition(js, labels, num_clients=30,
                                          samples_per_client=4, seed=seed)
    pi, psz = partition.build_partition(ps, labels, num_clients=30,
                                        samples_per_client=4, seed=seed)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(psz, jsz)
    assert pi.dtype == ji.dtype and psz.dtype == jsz.dtype


def test_dirichlet_severity_one_raises_where_the_reference_raises():
    """alpha = 1e-3 can make RandomState.dirichlet return NaN; both copies
    must then raise the same error (and return the same cut otherwise)."""
    labels = np.random.RandomState(5).randint(0, 6, 900)
    outcomes = []
    for seed in range(12):
        res = []
        for mod in (j_partition, partition):
            try:
                idx, _ = mod.build_partition(
                    mod.PartitionSpec("dirichlet", severity=1.0), labels,
                    num_clients=180, samples_per_client=5, seed=seed)
                res.append(("ok", idx.tobytes()))
            except ValueError as e:
                res.append(("raise", str(e)))
        assert res[0] == res[1], seed
        outcomes.append(res[0][0])
    assert "raise" in outcomes and "ok" in outcomes


def test_partition_errors_match():
    labels = np.arange(10) % 2
    for mod in (j_partition, partition):
        with pytest.raises(ValueError, match="infeasible"):
            mod.build_partition(mod.PartitionSpec("iid"), labels,
                                num_clients=6, samples_per_client=2)
        with pytest.raises(ValueError, match="severity"):
            mod.build_partition(mod.PartitionSpec("label", severity=1.5),
                                labels, num_clients=2, samples_per_client=2)
        with pytest.raises(ValueError, match="unknown partition"):
            mod.build_partition(mod.PartitionSpec("nope"), labels,
                                num_clients=2, samples_per_client=2)


def _reference_draws(key, h, w, crop_frac=0.8):
    """The draws ``augment_image`` makes from ``key`` (augment.py:18-30)."""
    kc, kf, kb, kcon = jax.random.split(key, 4)
    ch, cw = int(h * crop_frac), int(w * crop_frac)
    return (int(jax.random.randint(kc, (), 0, h - ch + 1)),
            int(jax.random.randint(kc, (), 0, w - cw + 1)),
            bool(jax.random.bernoulli(kf)),
            float(jax.random.uniform(kb)), float(jax.random.uniform(kcon)))


@pytest.mark.parametrize("h,w", [(16, 16), (12, 20)])
def test_augment_matches_reference_given_its_draws(h, w):
    rng = np.random.RandomState(h * w)
    imgs = rng.rand(12, h, w, 3).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(h + w), 12)
    ref = np.stack([np.asarray(j_augment.augment_image(k, jnp.asarray(im)))
                    for k, im in zip(keys, imgs)])
    draws = list(zip(*[_reference_draws(k, h, w) for k in keys]))
    assert True in draws[2] and False in draws[2]      # both flip branches
    d = augment.AugmentDraws(torch.tensor(draws[0]), torch.tensor(draws[1]),
                             torch.tensor(draws[2]),
                             torch.tensor(draws[3], dtype=torch.float32),
                             torch.tensor(draws[4], dtype=torch.float32))
    out = augment.augment_images(torch.from_numpy(imgs), d)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_square_crops_lie_on_the_diagonal():
    # the reference draws top and left from one key; on square images the
    # port reproduces the equal offsets
    gen = torch.Generator().manual_seed(0)
    d = augment.draw_augment(gen, 64, 32, 32)
    assert torch.equal(d.top, d.left)
    assert int(d.top.min()) >= 0 and int(d.top.max()) <= 32 - 25
    for k in jax.random.split(jax.random.PRNGKey(0), 16):
        top, left, *_ = _reference_draws(k, 32, 32)
        assert top == left


def test_federated_dataset_matches_reference_partition():
    imgs, labels = synthetic.synthetic_labeled_images(80, 4, image_size=8,
                                                      seed=2)
    spec_j = j_partition.PartitionSpec("dirichlet", alpha=0.0)
    spec_p = partition.PartitionSpec("dirichlet", alpha=0.0)
    ds_j = j_pipeline.FederatedDataset.build(
        {"images": imgs}, labels, num_clients=40, samples_per_client=2,
        partition=spec_j, seed=3)
    ds_p = pipeline.FederatedDataset.build(
        {"images": imgs}, labels, num_clients=40, samples_per_client=2,
        partition=spec_p, seed=3)
    np.testing.assert_array_equal(ds_p.client_index, ds_j.client_index)
    np.testing.assert_array_equal(ds_p.client_sizes, ds_j.client_sizes)


def test_round_sampler_and_round_batch():
    imgs, labels = synthetic.synthetic_labeled_images(60, 3, image_size=8,
                                                      seed=1)
    ds = pipeline.FederatedDataset.build(
        {"images": imgs}, labels, num_clients=20, samples_per_client=3,
        partition=partition.PartitionSpec("dirichlet_quantity",
                                          severity=0.8), seed=0)
    sampler = ds.make_round_sampler(5, "cpu")
    b1, s1 = sampler(torch.Generator().manual_seed(9))
    b2, s2 = sampler(torch.Generator().manual_seed(9))
    assert b1["v1"].shape == (5, 3, 8, 8, 3) and s1.dtype == torch.int32
    torch.testing.assert_close(b1["v1"], b2["v1"], rtol=0, atol=0)
    torch.testing.assert_close(s1, s2, rtol=0, atol=0)
    assert float(b1["v2"].min()) >= 0 and float(b1["v2"].max()) <= 1
    # the host-gathering path draws the same cohort and views
    hb, hs = ds.round_batch(torch.Generator().manual_seed(9), 5)
    torch.testing.assert_close(hb["v1"], b1["v1"], rtol=0, atol=0)
    torch.testing.assert_close(hs, s1, rtol=0, atol=0)
    # sizes are the selected clients' true sizes
    assert set(s1.tolist()) <= set(ds.client_sizes.tolist())
