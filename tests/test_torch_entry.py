"""The port's entry points: the training CLI on the CPU, its refusal to run
on the CPU unasked, and the port's independence from JAX and the
reference package."""
import os
from pathlib import Path
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import train

# tier-1 runs 6 pytest workers on the machine's cores: one torch thread
# per worker keeps them from contending with each other and with JAX
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMALL = ["--rounds", "2", "--eval-every", "2", "--dataset-size", "64",
         "--clients-per-round", "4", "--num-classes", "3"]


def _run(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_train_cli_runs_two_smoke_rounds_on_cpu():
    out = _run(["-m", "repro_torch.launch.train", "--device", "cpu", *SMALL])
    assert out.returncode == 0, out.stderr
    assert "round     2 loss=" in out.stdout
    assert "final loss" in out.stdout


def test_train_raises_without_gpu_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present, so the default device is valid")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(SMALL)


def test_train_main_returns_a_summary_on_cpu():
    res = train.main(["--device", "cpu", "--stats-kernel", "off", *SMALL])
    assert res["device"] == "cpu" and res["loss_finite"]
    assert len(res["history"]) == 2 and len(res["round_ms"]) == 2
    assert 0.0 <= res["probe"] <= 1.0


def test_train_rejects_unported_choices():
    for arch in ("deepseek-v2-lite-16b", "zamba2-2.7b"):
        with pytest.raises(NotImplementedError, match="Transformer families"):
            train.main(["--device", "cpu", "--arch", arch, *SMALL])
    with pytest.raises(SystemExit):
        train.main(["--device", "cpu", "--stats-kernel", "pallas", *SMALL])
    with pytest.raises(SystemExit):
        train.main(["--device", "cpu", "--severity", "0.5", *SMALL])


def test_train_refuses_seq_len_on_the_image_tower():
    with pytest.raises(SystemExit, match="--seq-len"):
        train.main(["--device", "cpu", "--seq-len", "32", *SMALL])


def test_train_runs_the_full_moment_objective_on_cpu():
    res = train.main(["--device", "cpu", "--objective", "dwmse", *SMALL])
    assert res["loss_finite"] and len(res["history"]) == 2
    assert res["wire_bytes"] == 0.0


def test_train_runs_a_quantized_uplink_on_cpu(capsys):
    res = train.main(["--device", "cpu", "--channel", "quant",
                      "--quant-bits", "4", "--stats-kernel", "off", *SMALL])
    assert res["loss_finite"] and res["wire_bytes"] > 0
    assert "channel QuantizedChannel(bits=4): uplink" in \
        capsys.readouterr().out
    # without --stats-kernel a lossy channel takes the per-client phase 1
    res = train.main(["--device", "cpu", "--channel", "dp", "--dp-sigma",
                      "2.0", *SMALL])
    assert "DP epsilon=" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    ["--objective", "dvicreg", "--lam", "3"],
    ["--quant-bits", "4"],
    ["--channel", "int8", "--quant-bits", "4"],
    ["--quant-kernel", "off"],
    ["--channel", "dense", "--dp-sigma", "2"],
    ["--channel", "dp", "--dropout-p", "0.2"],
])
def test_train_refuses_flags_it_would_ignore(flags):
    with pytest.raises(SystemExit):
        train.main(["--device", "cpu", *flags, *SMALL])


def test_train_refuses_a_lossy_channel_on_the_flat_kernel_path():
    with pytest.raises(ValueError, match="per-client payloads"):
        train.main(["--device", "cpu", "--channel", "quant",
                    "--stats-kernel", "fused", *SMALL])


@pytest.mark.parametrize("flags,line", [
    (["--edges", "2", "--channel", "int8", "--edge-channel", "dense"],
     "uplink per hop: client->edge"),
    (["--edges", "2", "--edge-channel", "dropout", "--dropout-p", "0.3"],
     "uplink per hop: client->edge"),
    (["--clusters", "2", "--cluster-iters", "3"], "final loss"),
    (["--async-k", "2", "--latency-tail", "1.0", "--staleness", "poly"],
     "updates="),
])
def test_train_runs_the_tree_clustered_and_buffered_paths_on_cpu(
        capsys, flags, line):
    from repro_torch.kernels.segment_sum import segment_sum
    before = dict(segment_sum.launches)
    res = train.main(["--device", "cpu", *flags, *SMALL])
    assert res["loss_finite"] and len(res["history"]) == 2
    assert line in capsys.readouterr().out
    assert segment_sum.launches == before     # the plain version on CPU
    if "--edges" in flags:
        assert res["wire_bytes"] > res["edge_bytes"] > 0
    else:
        assert res["wire_bytes"] == res["edge_bytes"] == 0.0
    if "--async-k" in flags:
        assert 0 <= res["updates"] <= 2


@pytest.mark.parametrize("flags", [
    ["--clusters", "2", "--async-k", "2"],
    ["--clusters", "2", "--stats-kernel", "fused"],
    ["--clusters", "2", "--channel", "dp"],
    ["--clusters", "2", "--edges", "4"],
    ["--clusters", "5"],
    ["--cluster-iters", "3"],
    ["--async-k", "2", "--channel", "dp"],
    ["--async-k", "2", "--stats-kernel", "fused"],
    ["--async-k", "5"],
    ["--staleness", "poly"],
    ["--latency-tail", "1.0"],
    ["--edges", "3"],
    ["--edges", "2", "--channel", "dp"],
    ["--edge-channel", "int8"],
    ["--edges", "2", "--dropout-p", "0.2"],
])
def test_train_refuses_bad_tree_cluster_and_buffer_flags(flags):
    with pytest.raises(SystemExit):
        train.main(["--device", "cpu", *flags, *SMALL])


def test_train_refuses_a_lossy_tree_under_the_buffer():
    with pytest.raises(ValueError, match="lossy edge hop"):
        train.main(["--device", "cpu", "--async-k", "2", "--edges", "2",
                    "--channel", "int8", *SMALL])


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:\.|\s|$)",
                     re.MULTILINE)


def test_port_sources_import_neither_jax_nor_the_reference():
    tools = sorted((ROOT / "tools").glob("*.py"))
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + tools
    assert len(files) > 20 and ROOT / "tools" / "time_cco_stats.py" in tools
    names = {f.relative_to(PORT).as_posix() for f in files
             if f.is_relative_to(PORT)}
    assert {"comm/channel.py", "comm/quantize.py", "comm/accountant.py",
            "core/vicreg.py", "core/wmse.py", "kernels/quantize.py",
            "kernels/segment_sum.py", "hierarchy/aggregation.py",
            "cluster/kmeans.py", "cluster/round.py", "core/buffer.py",
            "data/latency.py", "kernels/mips_topk.py", "retrieval/index.py",
            "retrieval/server.py", "retrieval/sharded.py",
            "retrieval/ivf.py", "kernels/flash_attention.py",
            "models/attention.py", "models/transformer.py",
            "configs/tinyllama_1_1b.py", "configs/qwen3_1_7b.py",
            "configs/qwen3_8b.py", "configs/granite_3_8b.py"} <= names
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if _IMPORT.search(f.read_text())]
    assert not offenders, offenders


def test_port_loads_no_jax_module_at_run_time():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from repro_torch.launch import train\n"
        f"train.main({['--device', 'cpu', *SMALL]!r})\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = _run(["-c", code])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")


def test_profile_round_runs_on_cpu():
    from repro_torch.launch import profile_round
    res = profile_round.main(["--device", "cpu", "--clients-per-round", "2",
                              "--dataset-size", "32", "--warmup", "1",
                              "--rounds", "1"])
    assert res["wall_ms"] > 0
    assert res["busy_ms"] is None          # no device time on the CPU
    assert profile_round._layer("cco_stats_cross_kernel").startswith(
        "phase-1")
    assert profile_round._layer("sm90_xmma_fprop_implicit_gemm").startswith(
        "convolutions")
