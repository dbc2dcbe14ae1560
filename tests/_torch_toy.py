"""A toy dual encoder shared by the port's hierarchy, cluster and buffer
tests: ``tanh(x @ w1) @ w2`` on both views, the same numpy parameters and
client data on the reference's side (JAX) and the port's (torch), so a
round of either can be compared without the ResNet's layout conversions.
Everything is f32 and made from a numpy seed."""
import jax.numpy as jnp
import numpy as np
import torch

N_CLIENTS, N_PER, DIM_IN, DIM_OUT = 20, 3, 10, 6
LAM = 5.0


def params_np(seed=0):
    rng = np.random.RandomState(seed)
    return {"w1": (rng.randn(DIM_IN, 16) * 0.3).astype(np.float32),
            "w2": (rng.randn(16, DIM_OUT) * 0.3).astype(np.float32)}


def pool_np(seed=1, clients=N_CLIENTS, per=N_PER):
    """Client data (clients, per, DIM_IN) for both views: three groups of
    clients around their own mean direction, so that clustering has
    something to find."""
    rng = np.random.RandomState(seed)
    means = rng.randn(3, DIM_IN) * 2.0
    group = np.arange(clients) % 3
    base = means[group][:, None, :]
    return {v: (base + rng.randn(clients, per, DIM_IN)).astype(np.float32)
            for v in ("v1", "v2")}


def j_apply(p, batch):
    def enc(x):
        return jnp.tanh(x @ p["w1"]) @ p["w2"]
    return enc(batch["v1"]), enc(batch["v2"])


def t_apply(p, batch):
    def enc(x):
        return torch.tanh(x @ p["w1"]) @ p["w2"]
    return enc(batch["v1"]), enc(batch["v2"])


def to_jax(tree):
    return {k: (to_jax(v) if isinstance(v, dict) else jnp.asarray(v))
            for k, v in tree.items()}


def to_torch(tree):
    return {k: (to_torch(v) if isinstance(v, dict)
                else torch.tensor(np.asarray(v)))
            for k, v in tree.items()}


def max_diff(a, b):
    """max |a - b| over two dict trees (numpy-convertible leaves)."""
    if isinstance(a, dict):
        return max(max_diff(a[k], b[k]) for k in a)
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())
