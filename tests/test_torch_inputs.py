"""``launch/inputs.py`` and ``kernels/ops.py`` in the port against the
reference, on the CPU: for every arch and every assigned input shape, the
meta-device stand-ins have the shapes and dtypes of the reference's
``ShapeDtypeStruct`` specs and the long-context variant is the
reference's; the re-exported kernel entry points equal the reference's
``use_pallas=False`` route (the plain oracles) to f32 rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS as J_ARCH_IDS
from repro.configs.base import get_config as j_get_config
from repro.kernels import ops as j_ops
from repro.launch import inputs as j_inputs
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.kernels import ops
from repro_torch.kernels.cco_stats import cco_stats
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import inputs

torch.set_num_threads(1)


def _layout(tree):
    """(path, shape, dtype name) of each leaf, in tree order."""
    return [(jax.tree_util.keystr(p), tuple(x.shape),
             str(x.dtype).replace("torch.", ""))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_the_shapes_are_the_references():
    assert inputs.INPUT_SHAPES == {
        k: inputs.InputShape(v.name, v.seq_len, v.global_batch, v.kind)
        for k, v in j_inputs.INPUT_SHAPES.items()}
    assert inputs.LONG_CONTEXT_WINDOW == j_inputs.LONG_CONTEXT_WINDOW
    assert set(ARCH_IDS) == set(J_ARCH_IDS)


@pytest.mark.parametrize("shape", sorted(j_inputs.INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_and_variant_match_reference(arch, shape):
    js = j_inputs.INPUT_SHAPES[shape]
    ts = inputs.INPUT_SHAPES[shape]
    jcfg = j_inputs.arch_variant_for_shape(j_get_config(arch), js)
    tcfg = inputs.arch_variant_for_shape(get_config(arch), ts)
    assert tcfg.sliding_window == jcfg.sliding_window
    for fn in ("train_input_specs", "prefill_input_specs",
               "decode_input_specs"):
        want = getattr(j_inputs, fn)(jcfg, js)
        got = getattr(inputs, fn)(tcfg, ts)
        assert _layout(got) == _layout(want), fn
        assert all(x.device.type == "meta"
                   for x in jax.tree_util.tree_leaves(got))


def test_ops_match_the_references_plain_route():
    rng = np.random.RandomState(0)
    zf, zg = rng.randn(37, 24).astype(np.float32), rng.randn(37, 24).astype(
        np.float32)
    want = j_ops.cco_stats(jnp.asarray(zf), jnp.asarray(zg),
                           use_pallas=False)
    got = ops.cco_stats(torch.from_numpy(zf), torch.from_numpy(zg))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)
    q = rng.randn(2, 4, 40, 32).astype(np.float32)
    k, v = (rng.randn(2, 2, 40, 32).astype(np.float32) for _ in range(2))
    for causal, window in ((True, 0), (True, 16), (False, 0)):
        want = j_ops.flash_attention(*map(jnp.asarray, (q, k, v)),
                                     causal=causal, window=window,
                                     use_pallas=False)
        got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)
    # one route: the port's wrappers themselves, counters and all
    assert ops.cco_stats is cco_stats
    assert ops.flash_attention is flash_attention
