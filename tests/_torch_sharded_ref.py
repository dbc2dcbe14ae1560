"""The reference's side of the sharded-cohort tests: a toy cohort made from
a numpy seed, the reference's shard-folded quantizer draws carried to the
port's ranks, and the reference's own ``stats_round_sharded`` run in a
subprocess on forced CPU devices (the device count must be set before
JAX initializes, so it needs a fresh interpreter).

The reference's rank r of a sharded quantized round draws from
``fold_in(fold_in(round key, r), PHASE_SALT[phase])`` (a tree's client
hop too: its rank context is a plain one), one uniform draw of (K / S,
payload size) split per leaf in ``jax.tree.flatten`` order.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_dist import LAM, LR
from repro.comm import channel as j_channel

K, N_PER, D_IN, D_OUT = 16, 3, 10, 6
SIZES = np.array([3, 2, 3, 1, 3, 2, 3, 3, 1, 3, 2, 3, 3, 1, 2, 3],
                 np.int32)
EDGES = 8
CHANNEL_SEED = 11
ROOT = Path(__file__).resolve().parents[1]


def cohort(seed=0):
    """(params, batch, sizes) as numpy: the toy encoder's two matrices and
    K clients of N_PER samples of both views."""
    rng = np.random.RandomState(seed)
    params = {"w1": (rng.randn(D_IN, 16) * 0.3).astype(np.float32),
              "w2": (rng.randn(16, D_OUT) * 0.3).astype(np.float32)}
    base = rng.randn(K, 1, D_IN) * 1.5
    batch = {v: (base + rng.randn(K, N_PER, D_IN)).astype(np.float32)
             for v in ("v1", "v2")}
    return params, batch, SIZES.copy()


def to_torch(tree):
    return {k: (to_torch(v) if isinstance(v, dict)
                else torch.tensor(np.asarray(v)))
            for k, v in tree.items()}


def ref_uniforms(key, shapes):
    """The reference quantizer's uniforms for a payload of leaf ``shapes``
    (a dict), one (k, total) draw split per leaf in flatten order."""
    leaves, treedef = jax.tree.flatten(
        {n: jnp.zeros(s, jnp.float32) for n, s in shapes.items()})
    k = leaves[0].shape[0]
    sizes = [int(np.prod(x.shape[1:])) for x in leaves]
    flat = np.asarray(jax.random.uniform(key, (k, sum(sizes))))
    parts = np.split(flat, np.cumsum(sizes)[:-1], axis=1)
    return jax.tree.unflatten(treedef, [
        torch.tensor(p.reshape(x.shape)) for p, x in zip(parts, leaves)])


def shard_draws(shards: int, payloads, tree: bool):
    """Each rank's ``channel_draws`` carrying the reference's: per phase,
    the uniforms of its K / S clients (under ``"client"`` for a tree,
    whose dense edge hop draws nothing)."""
    key = jax.random.PRNGKey(CHANNEL_SEED)
    out = []
    for r in range(shards):
        rank_key = jax.random.fold_in(key, r)
        draws = {}
        for phase, shapes in payloads.items():
            u = ref_uniforms(jax.random.fold_in(
                rank_key, j_channel.PHASE_SALT[phase]),
                {n: (K // shards,) + s for n, s in shapes.items()})
            draws[phase] = {"client": u} if tree else u
        out.append(draws)
    return out


def payload_shapes(params):
    """{"stats": D-CCO's stat shapes at D_OUT, "update": the params'}."""
    from repro_torch.objectives import get_objective

    return {"stats": get_objective("dcco", lam=LAM).stat_spec(D_OUT),
            "update": {n: tuple(v.shape) for n, v in params.items()}}


_SCRIPT = r"""
import sys
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from repro import comm, hierarchy
from repro.core import round_engine
from repro.optim import optimizers as opt_lib

src, dst, shards, lam, lr, edges, seed = sys.argv[1:8]
shards, lam, lr, edges = int(shards), float(lam), float(lr), int(edges)
z = np.load(src)
params = {"w1": jnp.asarray(z["w1"]), "w2": jnp.asarray(z["w2"])}
data = {"v1": jnp.asarray(z["v1"]), "v2": jnp.asarray(z["v2"])}
sizes = jnp.asarray(z["sizes"])
devs = np.array(jax.devices()[:shards])
if shards == 2:
    mesh, axis = Mesh(devs, ("data",)), "data"
else:
    mesh, axis = Mesh(devs.reshape(2, shards // 2),
                      ("data", "client")), ("data", "client")

def apply(p, b):
    enc = lambda x: jnp.tanh(x @ p["w1"]) @ p["w2"]
    return enc(b["v1"]), enc(b["v2"])

opt = opt_lib.sgd(lr)
out = {}
for name, ch in (
        ("int8", comm.QuantizedChannel(8)),
        ("tree", hierarchy.HierarchicalChannel(
            edges, client_channel=comm.QuantizedChannel(8)))):
    p, _, m = jax.jit(lambda p, o: round_engine.dcco_round_sharded(
        apply, p, o, opt, data, sizes, mesh, lam=lam, client_lr=lr,
        axis=axis, channel=ch,
        channel_key=jax.random.PRNGKey(int(seed))))(params,
                                                     opt.init(params))
    for leaf in ("w1", "w2"):
        out[f"{name}/{leaf}"] = np.asarray(p[leaf])
    out[f"{name}/loss"] = np.asarray(m.loss)
    out[f"{name}/encoding_std"] = np.asarray(m.encoding_std)
    out[f"{name}/wire_bytes"] = np.asarray(m.wire_bytes)
np.savez(dst, **out)
print("REF_SHARDED_OK")
"""


def run_reference_sharded(tmp_path, shards: int):
    """The reference's sharded int8 and int8-tree rounds of ``cohort()``
    over ``shards`` forced CPU devices (a (2, shards / 2) ("data",
    "client") mesh when shards > 2): {name: {leaf or metric: ndarray}}."""
    params, batch, sizes = cohort()
    src = Path(tmp_path) / "ref_in.npz"
    dst = Path(tmp_path) / "ref_out.npz"
    np.savez(src, sizes=sizes, **params, **batch)
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": (env.get("XLA_FLAGS", "") + " --xla_force_host_"
                      f"platform_device_count={shards}").strip(),
        "PYTHONPATH": os.pathsep.join(
            [str(ROOT / "src")]
            + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))})
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(src), str(dst), str(shards),
         str(LAM), str(LR), str(EDGES), str(CHANNEL_SEED)],
        env=env, capture_output=True, text=True, timeout=180)
    assert res.returncode == 0 and "REF_SHARDED_OK" in res.stdout, \
        f"stdout={res.stdout}\nstderr={res.stderr}"
    z = np.load(dst)
    out = {}
    for key in z.files:
        name, leaf = key.split("/")
        out.setdefault(name, {})[leaf] = z[key]
    return out
