"""The xLSTM tower's bf16 rounding in both packages, on the CPU.

One set of bf16 weights, drawn by the reference's ``init_params`` and
converted, at the full depth of xlstm-350m (12 mLSTM + sLSTM
superblocks) and a reduced width. Each package runs the tower's forward
twice over the same tokens: in bf16, and in f32 on the same weights cast
up. Its bf16 gap is max |logits_bf16 - logits_f32| / max |logits_f32|.
If the port's gap matches the reference's, the distance of its bf16
decode from a bf16 forward on the card is bf16 rounding of this tower,
not a port fault. The two packages' f32 logits, and their bf16 logits,
are compared across the frameworks as well.

  PYTHONPATH=src python tests/_torch_xlstm_bf16.py [--width 128 --heads 2]

prints the gaps as JSON.
"""
import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_config as j_get_config
from repro.models import transformer as j_tf
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.models import transformer

ARCH = "xlstm-350m"


def _rel(a, b, scale) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / scale)


def gaps(width: int = 128, heads: int = 2, batch: int = 2, seq: int = 32,
         seeds=(0,)) -> dict:
    """For each seed (weights and tokens), the bf16 gaps of both packages
    and the cross-framework distances (relative to the reference's
    largest f32 logit), at full depth."""
    full = j_get_config(ARCH)
    kw = dict(num_layers=full.num_layers, d_model=width, num_heads=heads,
              num_kv_heads=heads, vocab_size=256)
    j32 = j_get_config(ARCH, smoke=True).replace(**kw)
    t32 = get_config(ARCH, smoke=True).replace(**kw)
    j16, t16 = j32.replace(dtype="bfloat16"), t32.replace(dtype="bfloat16")
    init = jax.jit(lambda k: j_tf.init_params(j16, k))
    ref_fn = {cfg.dtype: jax.jit(lambda p, t, cfg=cfg: j_tf.logits_from_hidden(
        cfg, p, j_tf.forward(cfg, p, t)).astype(jnp.float32))
        for cfg in (j16, j32)}

    def port_logits(cfg, p, tokens):
        p = convert.params_from_jax(jax.tree.map(np.asarray, p))
        with torch.no_grad():
            h = transformer.forward(cfg, p, torch.from_numpy(tokens))
            return transformer.logits_from_hidden(cfg, p, h).float().numpy()

    out = {"layers": kw["num_layers"], "width": width, "seeds": list(seeds)}
    for seed in seeds:
        jp16 = init(jax.random.PRNGKey(seed))
        jp32 = jax.tree.map(lambda x: x.astype(jnp.float32) if jnp.issubdtype(
            x.dtype, jnp.floating) else x, jp16)
        tokens = np.random.RandomState(seed + 1).randint(
            0, kw["vocab_size"], (batch, seq)).astype(np.int32)
        ref = {"bf16": np.asarray(ref_fn["bfloat16"](jp16, tokens)),
               "f32": np.asarray(ref_fn["float32"](jp32, tokens))}
        port = {"bf16": port_logits(t16, jp16, tokens),
                "f32": port_logits(t32, jp32, tokens)}
        scale = float(np.abs(ref["f32"]).max())
        for name, a, b in (
                ("reference_bf16_gap", ref["bf16"], ref["f32"]),
                ("port_bf16_gap", port["bf16"], port["f32"]),
                ("f32_across", port["f32"], ref["f32"]),
                ("bf16_across", port["bf16"], ref["bf16"])):
            out.setdefault(name, []).append(_rel(a, b, scale))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args(argv)
    print(json.dumps(gaps(args.width, args.heads, seq=args.seq,
                          seeds=tuple(range(args.seeds)))))


if __name__ == "__main__":
    main()
