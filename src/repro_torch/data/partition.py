"""Client dataset partitioning (paper Sec 4.1) — strategies as data.

A :class:`PartitionSpec` names a strategy plus one normalized ``severity``
in [0, 1], which each strategy maps onto its own parameter:

  ``iid``                 shuffled uniform assignment (severity-flat)
  ``uniform``             class-stratified equal split (severity-flat)
  ``label``               ``m = round(C - severity*(C-1))`` classes/client
  ``dirichlet``           ``alpha = 10**(3 - 6*severity)``
  ``dirichlet_quantity``  client sizes ~ Dir(beta), labels IID,
                          ``beta = 10**(3 - 6*severity)``

numpy ``RandomState`` code, kept equal to the reference index for index.
Where the reference raises, this copy raises the same error: at severity
1.0 the ``dirichlet`` strategy's alpha = 1e-3 can make
``RandomState.dirichlet`` return NaN, and ``choice`` then raises
``ValueError: probabilities contain NaN``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np


class PartitionSpec(NamedTuple):
    """A named partition strategy + its normalized severity knob.
    ``alpha`` is the raw Dirichlet concentration of the deprecated
    ``--alpha`` spelling; when set, ``dirichlet`` uses it verbatim."""
    strategy: str = "dirichlet"
    severity: float = 1.0
    alpha: Optional[float] = None


def check_feasible(num_samples: int, num_clients: int,
                   samples_per_client: int) -> None:
    """Raise a clear ValueError when the demanded partition cannot be cut
    from the dataset."""
    need = num_clients * samples_per_client
    if need > num_samples:
        raise ValueError(
            f"infeasible partition: {num_clients} clients x "
            f"{samples_per_client} samples/client = {need} samples, but the "
            f"dataset has only {num_samples}; at this client size it "
            f"supports at most {num_samples // samples_per_client} clients "
            f"(or {num_samples // num_clients} samples/client for "
            f"{num_clients} clients)")


def severity_to_alpha(severity: float) -> float:
    """severity in [0,1] -> Dirichlet concentration, from alpha=1000 at
    severity 0 to alpha=1e-3 at severity 1."""
    return float(10.0 ** (3.0 - 6.0 * float(severity)))


def severity_to_classes(severity: float, num_classes: int) -> int:
    """severity in [0,1] -> classes held per client for ``label``."""
    m = int(round(num_classes - float(severity) * (num_classes - 1)))
    return max(1, min(num_classes, m))


def dirichlet_partition(labels: np.ndarray, num_clients: int,
                        samples_per_client: int, alpha: float,
                        seed: int = 0) -> np.ndarray:
    """Returns index array (num_clients, samples_per_client) into the dataset.

    alpha == 0 is handled as the limit: each client draws all its samples
    from one uniformly-chosen class (paper's fully non-IID setting).
    """
    labels = np.asarray(labels)
    check_feasible(len(labels), num_clients, samples_per_client)
    rng = np.random.RandomState(seed)
    classes = np.unique(labels)
    pools = {c: rng.permutation(np.where(labels == c)[0]).tolist()
             for c in classes}
    out = np.zeros((num_clients, samples_per_client), np.int64)
    for k in range(num_clients):
        if alpha <= 0:
            probs = np.zeros(len(classes))
            probs[rng.randint(len(classes))] = 1.0
        else:
            probs = rng.dirichlet(alpha * np.ones(len(classes)))
        for s in range(samples_per_client):
            # resample class until its pool is non-empty; check_feasible
            # guarantees some pool is, so the redirect below terminates
            for _ in range(100):
                c = classes[rng.choice(len(classes), p=probs)]
                if pools[c]:
                    break
                nonempty = [i for i, cc in enumerate(classes) if pools[cc]]
                probs = np.zeros(len(classes))
                probs[rng.choice(nonempty)] = 1.0
            out[k, s] = pools[c].pop()
    return out


def iid_partition(num_samples: int, num_clients: int, samples_per_client: int,
                  seed: int = 0) -> np.ndarray:
    check_feasible(num_samples, num_clients, samples_per_client)
    rng = np.random.RandomState(seed)
    idx = rng.permutation(num_samples)[: num_clients * samples_per_client]
    return idx.reshape(num_clients, samples_per_client)


def label_partition(labels: np.ndarray, num_clients: int,
                    samples_per_client: int, severity: float,
                    seed: int = 0) -> np.ndarray:
    """Pathological label sharding: client k holds ``m(severity)`` classes
    (rotating shards over the class list), its samples split evenly."""
    labels = np.asarray(labels)
    check_feasible(len(labels), num_clients, samples_per_client)
    rng = np.random.RandomState(seed)
    classes = np.unique(labels)
    ncls = len(classes)
    m = severity_to_classes(severity, ncls)
    pools = {c: rng.permutation(np.where(labels == c)[0]).tolist()
             for c in classes}
    out = np.zeros((num_clients, samples_per_client), np.int64)
    for k in range(num_clients):
        mine = [classes[(k * m + j) % ncls] for j in range(m)]
        for s in range(samples_per_client):
            c = mine[s % m]
            if not pools[c]:
                # deterministic spill: draw from the fullest remaining pool
                c = max(classes, key=lambda cc: len(pools[cc]))
            out[k, s] = pools[c].pop()
    return out


def uniform_partition(labels: np.ndarray, num_clients: int,
                      samples_per_client: int, severity: float = 0.0,
                      seed: int = 0) -> np.ndarray:
    """Class-stratified equal split (``severity`` accepted and ignored)."""
    del severity
    return label_partition(labels, num_clients, samples_per_client, 0.0, seed)


def dirichlet_quantity_partition(labels: np.ndarray, num_clients: int,
                                 samples_per_client: int, severity: float,
                                 seed: int = 0
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Quantity skew: client sizes ~ Dir(beta) over clients, floored at 1
    and capped at ``samples_per_client``. Returns ``(index, sizes)``; slots
    past a client's size repeat its first index and are masked out."""
    labels = np.asarray(labels)
    check_feasible(len(labels), num_clients, samples_per_client)
    rng = np.random.RandomState(seed)
    n = samples_per_client
    beta = severity_to_alpha(severity)
    q = rng.dirichlet(beta * np.ones(num_clients))
    sizes = np.clip(np.round(q * num_clients * n), 1, n).astype(np.int64)
    perm = rng.permutation(len(labels))[: int(sizes.sum())]
    out = np.zeros((num_clients, n), np.int64)
    off = 0
    for k in range(num_clients):
        take = perm[off:off + sizes[k]]
        off += int(sizes[k])
        out[k, :sizes[k]] = take
        out[k, sizes[k]:] = take[0]
    return out, sizes


def _iid_strategy(labels, num_clients, samples_per_client, severity,
                  seed=0):
    del severity
    return iid_partition(len(np.asarray(labels)), num_clients,
                         samples_per_client, seed)


def _dirichlet_strategy(labels, num_clients, samples_per_client, severity,
                        seed=0, alpha=None):
    if alpha is None:
        alpha = severity_to_alpha(severity)
    if alpha >= 1e6:        # "IID" at the build() level, as the reference
        return iid_partition(len(np.asarray(labels)), num_clients,
                             samples_per_client, seed)
    return dirichlet_partition(labels, num_clients, samples_per_client,
                               alpha, seed)


_REGISTRY = {
    "iid": _iid_strategy,
    "uniform": uniform_partition,
    "label": label_partition,
    "dirichlet": _dirichlet_strategy,
    "dirichlet_quantity": dirichlet_quantity_partition,
}

PARTITIONS = tuple(_REGISTRY)


def register_partition(name: str, fn: Callable) -> None:
    """Register a partition strategy under ``name`` (CLI-visible).

    ``fn(labels, num_clients, samples_per_client, severity, seed)`` must
    return either an ``(num_clients, samples_per_client)`` int index
    array (full-size clients) or an ``(index, sizes)`` pair for
    variable-size clients; ``build_partition`` normalizes both."""
    global PARTITIONS
    _REGISTRY[name] = fn
    PARTITIONS = tuple(_REGISTRY)


def get_partition(name: str) -> Callable:
    """Resolve a registered strategy name to its partition function."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise ValueError(f"unknown partition strategy {name!r}; "
                     f"expected one of {PARTITIONS}")


def build_partition(spec: PartitionSpec, labels, *, num_clients: int,
                    samples_per_client: int, seed: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Cut the client partition a :class:`PartitionSpec` describes.

    Returns ``(index, sizes)``: ``index`` is (num_clients,
    samples_per_client) int64 into the dataset, ``sizes`` the per-client
    valid-sample counts."""
    if not isinstance(spec, PartitionSpec):
        raise TypeError(f"expected a PartitionSpec, got {type(spec)!r}")
    fn = get_partition(spec.strategy)
    kwargs = {}
    if spec.alpha is not None:
        if spec.strategy != "dirichlet":
            raise ValueError(
                f"PartitionSpec.alpha overrides the Dirichlet concentration "
                f"and applies to the 'dirichlet' strategy only, not "
                f"{spec.strategy!r} — use severity instead")
        kwargs["alpha"] = float(spec.alpha)
    elif not 0.0 <= float(spec.severity) <= 1.0:
        raise ValueError(
            f"PartitionSpec.severity must be in [0, 1], got {spec.severity}")
    out = fn(labels, num_clients, samples_per_client, float(spec.severity),
             seed, **kwargs)
    if isinstance(out, tuple):
        idx, sizes = out
    else:
        idx, sizes = out, np.full((num_clients,), samples_per_client,
                                  np.int64)
    return np.asarray(idx, np.int64), np.asarray(sizes, np.int64)


# ------------------------------------------------------------ skew metric --

def label_dominance(labels, index, sizes=None) -> float:
    """Mean over clients of the fraction its most-common label holds: the
    monotone-in-severity label-skew metric (~1/C for IID clients, 1.0 for
    single-class clients). ``sizes`` masks padded slots of variable-size
    partitions."""
    labels = np.asarray(labels)
    index = np.asarray(index)
    k, n = index.shape
    if sizes is None:
        sizes = np.full((k,), n, np.int64)
    doms = []
    for i in range(k):
        lab = labels[index[i, : sizes[i]]]
        _, counts = np.unique(lab, return_counts=True)
        doms.append(counts.max() / float(sizes[i]))
    return float(np.mean(doms))
