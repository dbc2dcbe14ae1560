"""The reference's side of the dry-run tests: its ``build_case`` lowered
and compiled on 8 forced XLA host devices, a ("data", "model") = (2, 4)
mesh, with the arch's smoke config and a small shape patched in for the
arch's config and the named input shape (in the subprocess only; the
package is untouched), the case's ``dcco_impl`` and ``sharding`` passed
through, and ``memory_analysis()`` read as ``run_case`` reads it. The
device count must be set before JAX initializes, so the reference runs
in a fresh interpreter.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_SCRIPT = r"""
import json, sys
import jax
jax.devices()                       # 8 devices, before dryrun's own flag
from repro.configs.base import get_config
from repro.launch import dryrun, inputs as inp

cases = json.loads(sys.argv[1])
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
for key, (arch, name, seq, batch, kind, micro, *more) in cases.items():
    impl, sharding = (more + ["fused", "tp"][len(more):])[:2]
    smoke = get_config(arch, smoke=True)
    dryrun.get_config = lambda _arch, _c=smoke: _c
    inp.INPUT_SHAPES[name] = inp.InputShape(name, seq, batch, kind)
    step, args, in_sh, out_sh = dryrun.build_case(
        arch, name, mesh, num_microbatches=micro, dcco_impl=impl,
        sharding=sharding)
    donate = (1,) if kind == "decode" else (0, 1) if kind == "train" else ()
    with mesh:
        mem = jax.jit(step, in_shardings=in_sh, out_shardings=out_sh,
                      donate_argnums=donate).lower(*args).compile() \
            .memory_analysis()
    out[key] = {k: int(getattr(mem, k)) for k in
                ("argument_size_in_bytes", "output_size_in_bytes")}
print("REF_DRYRUN " + json.dumps(out))
"""


def reference_memory(cases: dict) -> dict:
    """{key: (arch, shape name, seq_len, global_batch, kind, micro[,
    dcco_impl[, sharding]])} -> {key: the reference's per-device argument
    and output bytes}; the impl is "fused" and the sharding "tp" where
    not given."""
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
        "PYTHONPATH": os.pathsep.join(
            [str(ROOT / "src")]
            + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))})
    res = subprocess.run([sys.executable, "-c", _SCRIPT, json.dumps(cases)],
                         env=env, capture_output=True, text=True,
                         timeout=240)
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("REF_DRYRUN ")]
    assert res.returncode == 0 and line, \
        f"stdout={res.stdout}\nstderr={res.stderr[-4000:]}"
    return json.loads(line[0][len("REF_DRYRUN "):])
