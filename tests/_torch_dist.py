"""Gloo worlds of CPU processes for the port's sharded paths.

``run_world(tmp_path, world, tasks, inputs)`` starts ``world`` processes
of this file, one rank each, joined through the REPRO_* environment
(``repro_torch.sharding.maybe_initialize_distributed``) with a FileStore
under ``tmp_path`` as coordinator: no TCP port, so worlds of parallel
test workers never collide. Every rank loads the same ``inputs``, runs
the named tasks on the port (it imports torch and ``repro_torch`` only)
and writes its outputs with ``torch.save``; the parent test loads them
and compares them with the reference. Each world has a 60 s collective
timeout and a 180 s deadline, so a hung collective fails the test rather
than the run.

  python tests/_torch_dist.py <task,task,...> <world dir>   (one rank)
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
DEADLINE_S = 180.0
LAM, LR = 5.0, 0.05


# ------------------------------------------------------------ the parent --

def run_world(tmp_path, world: int, tasks, inputs) -> list:
    """Run ``tasks`` on a gloo world of ``world`` ranks; returns each
    rank's outputs ({task: outputs})."""
    d = Path(tmp_path) / f"world{world}"
    d.mkdir()
    torch.save(inputs, d / "inputs.pt")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.update({"REPRO_COORDINATOR": f"file://{d}/store",
                "REPRO_NUM_PROCESSES": str(world),
                "OMP_NUM_THREADS": "1"})
    procs = []
    for r in range(world):
        env["REPRO_PROCESS_ID"] = str(r)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, ",".join(tasks), str(d)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + DEADLINE_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("a rank failed:\n" + "\n".join(
            f"--- rank {r} (rc {p.returncode}):\n{log}"
            for r, (p, log) in enumerate(zip(procs, logs))))
    return [torch.load(d / f"out{r}.pt", weights_only=True)
            for r in range(world)]


# ------------------------------------------------------- the toy model --

def t_apply(p, batch):
    """The toy dual encoder of tests/_torch_toy.py (which imports JAX)."""
    def enc(x):
        return torch.tanh(x @ p["w1"]) @ p["w2"]
    return enc(batch["v1"]), enc(batch["v2"])


def toy_sampler(pool, pool_sizes, k: int):
    """``sampler(gen) -> (batch, sizes)``: k clients of the pool, drawn
    without replacement on ``gen``."""
    def sampler(gen):
        idx = torch.randperm(pool_sizes.shape[0], generator=gen)[:k]
        return {v: x[idx] for v, x in pool.items()}, pool_sizes[idx]
    return sampler


def _metrics(m):
    return {"loss": m.loss, "encoding_std": m.encoding_std,
            "wire_bytes": torch.as_tensor(m.wire_bytes),
            "edge_bytes": torch.as_tensor(m.edge_bytes)}


# ------------------------------------------------------------ the tasks --

def _cohort_mesh(inp):
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding import make_multihost_mesh

    import torch.distributed as dist
    if inp["axis"] == "data":
        return make_debug_mesh(dist.get_world_size())
    return make_multihost_mesh(("data", "client"), ranks_per_host=2)


def task_rounds(inp):
    """One toy round each: lossless D-CCO (with the collectives it
    counts), the same through DenseChannel, D-VICReg, SCAFFOLD, and with
    the given per-rank draws an int8 round and an int8 round through an
    edge tree."""
    from repro_torch import comm
    from repro_torch.core import round_engine
    from repro_torch.hierarchy import HierarchicalChannel
    from repro_torch.objectives import get_objective
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.server import drift as drift_lib
    from repro_torch.sharding import axis_index, collectives

    mesh, axis = _cohort_mesh(inp), inp["axis"]
    rank = axis_index(mesh, axis)
    p0, batch, sizes = inp["params"], inp["batch"], inp["sizes"]
    opt = opt_lib.sgd(LR)
    kw = dict(axis=axis, client_lr=LR)
    out = {}

    def run(name, **extra):
        collectives.reset_counts()
        res = round_engine.dcco_round_sharded(
            t_apply, p0, opt.init(p0), opt, batch, sizes, mesh, lam=LAM,
            **{**kw, **extra})
        out[name] = {"params": res[0], **_metrics(res[-1]),
                     "counts": {k: torch.tensor([c["calls"], c["bytes"]])
                                for k, c in collectives.counts.items()}}
        if len(res) == 4:
            out[name]["c"], out[name]["c_slots"] = res[2]
        return res

    run("dcco")
    run("dense", channel=comm.DenseChannel(), channel_key=7)
    run("dvicreg", objective=get_objective("dvicreg"))
    run("scaffold", scaffold_state=drift_lib.scaffold_init(
        p0, sizes.shape[0]), local_steps=2, client_lr=0.01)
    try:
        round_engine.dcco_round_sharded(
            t_apply, p0, opt.init(p0), opt,
            {v: x[:-1] for v, x in batch.items()}, sizes[:-1], mesh,
            axis=axis)
    except ValueError as e:
        out["ragged_error"] = str(e)
    if "int8_draws" in inp:
        run("int8", channel=comm.QuantizedChannel(8), channel_key=11,
            channel_draws=inp["int8_draws"][rank])
        run("tree", channel=HierarchicalChannel(
            inp["edges"], client_channel=comm.QuantizedChannel(8)),
            channel_key=11, channel_draws=inp["tree_draws"][rank])
    return out


def task_engine(inp):
    """Three engine rounds over the cohort axis, lossless and with
    SCAFFOLD, from the toy sampler, checkpointing into a directory of
    this rank's own."""
    from repro_torch.core import round_engine
    from repro_torch.optim import optimizers as opt_lib

    import tempfile

    mesh = _cohort_mesh(inp)
    sampler = toy_sampler(inp["pool"], inp["pool_sizes"], inp["k"])
    ckpt_dir = tempfile.mkdtemp()
    out = {}
    for name, extra in (("lossless", {}),
                        ("scaffold", {"scaffold": True, "local_steps": 2,
                                      "client_lr": 0.01})):
        opt = opt_lib.sgd(LR)
        cfg = round_engine.EngineConfig(
            **{"lam": LAM, "client_lr": LR, "chunk_rounds": 2,
               "cohort_axis": inp["axis"], **extra})
        eng = round_engine.RoundEngine(t_apply, opt, sampler, cfg,
                                       mesh=mesh)
        p, _, m = eng.run(inp["params"], opt.init(inp["params"]), seed=3,
                          rounds=3, ckpt_dir=ckpt_dir, ckpt_every=2,
                          ckpt_name=name)
        out[name] = {"params": p, "loss": m.loss,
                     "encoding_std": m.encoding_std,
                     "checkpoints": sorted(os.listdir(ckpt_dir))}
        if eng.drift_state is not None:
            out[name]["c"], out[name]["c_slots"] = eng.drift_state
    return out


def task_losses(inp):
    """The shard_map losses over this rank's rows of a toy linear-tanh
    encoder: each loss and its parameter gradient summed over the ranks."""
    from repro_torch.core import dcco
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.objectives import get_objective, make_shard_map_loss
    from repro_torch.sharding import axis_index, axis_size, psum_tree

    import torch.distributed as dist
    mesh = make_debug_mesh(dist.get_world_size())
    s, r = axis_size(mesh, "data"), axis_index(mesh, "data")
    n = inp["x"].shape[0] // s
    x, y = inp["x"][r * n:(r + 1) * n], inp["y"][r * n:(r + 1) * n]
    out = {}
    for name in ("dcco", "dvicreg", "dwmse"):
        w = inp["w"].clone().requires_grad_()
        zf, zg = torch.tanh(x @ w), torch.tanh(y @ w)
        if name == "dcco":
            loss = dcco.dcco_loss(zf, zg, LAM, impl="shard_map", mesh=mesh)
        else:
            loss = make_shard_map_loss(get_objective(name), mesh)(zf, zg)
        (g,) = torch.autograd.grad(loss, w)
        out[name] = {"loss": loss.detach(), "grad": psum_tree(g, mesh,
                                                              "data")}
    return out


def task_step(inp):
    """One ``make_dcco_train_step(mesh=)`` step of the smoke ResNet on
    this rank's rows of the batch, at micro 1 and 2."""
    from repro_torch.configs.base import (DualEncoderConfig, TrainConfig,
                                          get_config)
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.sharding import axis_index, axis_size

    import torch.distributed as dist
    mesh = make_debug_mesh(dist.get_world_size())
    s, r = axis_size(mesh, "data"), axis_index(mesh, "data")
    cfg = get_config("resnet14-cifar", smoke=True).replace(resnet_groups=2)
    n = inp["views"][0].shape[0] // s
    batch = {f"view{i + 1}": {"images": v[r * n:(r + 1) * n]}
             for i, v in enumerate(inp["views"])}
    opt = opt_lib.sgd(inp["lr"])
    out = {}
    for micro in (1, 2):
        step = steps.make_dcco_train_step(
            cfg, DualEncoderConfig(proj_dims=(64, 64), lambda_cco=LAM),
            TrainConfig(global_batch=n * s, samples_per_client=2,
                        dcco_impl="shard_map"), opt, mesh=mesh,
            num_microbatches=micro, constrain_sharding=True)
        p, _, m = step(inp["params"], opt.init(inp["params"]), batch)
        out[f"micro{micro}"] = {"params": p, "loss": m["loss"],
                                "encoding_std": m["encoding_std"]}
    return out


def task_corpus(inp):
    """``ShardedCorpusIndex`` over a corpus mesh of the world: this rank
    keeps its shard; the search merges every rank's candidates."""
    from repro_torch import retrieval
    from repro_torch.sharding import make_corpus_mesh

    mesh = make_corpus_mesh()
    index = retrieval.ShardedCorpusIndex(inp["emb"], mesh.size(),
                                         mesh=mesh)
    v, i = index.search(inp["q"], inp["k"])
    out = {"values": v, "indices": i,
           "local_rows": torch.tensor(index.shards.shape[:2])}
    try:
        index.refresh(None, None, None, threshold=0.0)
    except NotImplementedError as e:
        out["refresh_error"] = str(e)
    return out


def task_mesh(inp):
    """The (hosts, ranks per host) mesh's shape and this rank's place,
    and host_local_to_global of a slice that names its rank."""
    from repro_torch.sharding import (axis_index, host_local_to_global,
                                      make_multihost_mesh)

    import torch.distributed as dist
    mesh = make_multihost_mesh(("data", "client"), ranks_per_host=2)
    r = dist.get_rank()
    local = {"a": torch.full((2, 3), float(r)),
             "b": torch.arange(2, dtype=torch.int32) + 10 * r}
    return {"shape": torch.tensor(tuple(mesh.shape)),
            "names": list(mesh.mesh_dim_names),
            "index": torch.tensor([axis_index(mesh, ("data", "client")),
                                   axis_index(mesh, "data"),
                                   axis_index(mesh, "client")]),
            "global": host_local_to_global(mesh, ("data", "client"), local),
            "replicated": host_local_to_global(mesh, None, local)}


def task_layouts(inp):
    """``make_production_mesh`` on the world (its ranks on one host, and
    seen as 2 hosts of 2 or hosts of 3), and each parameter tree laid out
    on the (2, 2) mesh by ``named(mesh, param_pspecs(...))`` (both modes;
    the Adam state by ZeRO-1's ``opt_state_pspecs``): every leaf's local
    shard shape, and whether ``full_tensor()`` gives the leaf back bit
    for bit."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.sharding import specs

    def shape_of(m):
        return list(m.shape), list(m.mesh_dim_names)

    def on_hosts_of(per, **kw):
        # a world of one machine, seen as hosts of ``per`` ranks
        real = mesh_lib.ranks_on_this_host
        mesh_lib.ranks_on_this_host = lambda: per
        try:
            return mesh_lib.make_production_mesh(**kw)
        finally:
            mesh_lib.ranks_on_this_host = real

    out = {"mesh": {"default": shape_of(mesh_lib.make_production_mesh())}}
    mesh = on_hosts_of(2)
    out["mesh"]["2x2"] = shape_of(mesh)
    out["mesh"]["multi_pod"] = shape_of(on_hosts_of(2, multi_pod=True))
    for key, make in (
            ("multi_pod_one_host",
             lambda: mesh_lib.make_production_mesh(multi_pod=True)),
            ("uneven", lambda: on_hosts_of(3))):
        try:
            make()
        except ValueError as e:
            out["mesh"][key] = str(e)

    def lay_out(tree, spec_tree):
        local, same = {}, {}

        def one(path, leaf, spec):
            dt = distribute_tensor(leaf, mesh, specs.named(mesh, spec))
            local[path] = torch.tensor(tuple(dt.to_local().shape))
            same[path] = torch.tensor(torch.equal(dt.full_tensor(), leaf))
        specs._map_with_path(one, tree, spec_tree)
        return {"local": local, "same": same}

    for arch, tree in inp["params"].items():
        for mode in ("tp", "fsdp"):
            out[f"{arch}/{mode}"] = lay_out(
                tree, specs.param_pspecs(tree, mesh, mode=mode))
    adam = inp["adam"]
    out["adam/zero1"] = lay_out(adam, specs.opt_state_pspecs(
        specs.param_pspecs(adam, mesh), adam, mesh))
    return out


def _whole(tree):
    from repro_torch import utils
    return utils.tree_map(lambda t: t.full_tensor(), tree)


def task_dryrun(inp):
    """The dry run's train programs with real values on the (2, 2)
    production mesh of the world, each beside the port's unsharded
    computation on the same inputs (DTensor results gathered whole with
    ``full_tensor``):

    * ``train``: the D-CCO train step of the smoke TinyLlama tower, tp-
      and fsdp-placed, with the fused loss, the shard_map loss (tp and
      fsdp) and the per-client loss (tp), and of the smoke DeepSeek-MoE
      tower (expert parallel, its balance and router-z losses in the
      loss), tp-placed: loss, gradients, updated parameters, the counts
      of ``sharding.collectives`` over the gradient's call; and the MoE
      tower's encoding with its aux values;
    * ``knobs``: the TinyLlama tower's forward on the tp-placed parameters
      with and without ``act_shard_axes`` and ``fsdp_model_size``."""
    from repro_torch.configs.base import TrainConfig, get_config, \
        get_dual_encoder_config
    from repro_torch.launch import dryrun, inputs as inp_lib
    from repro_torch.launch import mesh as mesh_lib, steps
    from repro_torch.models import dual_encoder, transformer
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.sharding import collectives

    mesh = mesh_lib.make_production_mesh(ranks_per_host=2)
    out = {"train": {}}
    shape = inp_lib.InputShape("train_s", 16, 8, "train")
    opt = opt_lib.adam(5e-3)
    for arch, mode, micro, impl in (
            ("tinyllama-1.1b", "tp", 2, "fused"),
            ("tinyllama-1.1b", "fsdp", 1, "fused"),
            ("deepseek-moe-16b", "tp", 1, "fused"),
            ("tinyllama-1.1b", "tp", 1, "shard_map"),
            ("tinyllama-1.1b", "fsdp", 1, "shard_map"),
            ("tinyllama-1.1b", "tp", 1, "per_client")):
        cfg = get_config(arch, smoke=True)
        de_cfg = get_dual_encoder_config(arch)
        params, batch = inp["train"][arch]["params"], inp["train"][arch][
            "batch"]
        values = {"params": params, "opt_state": opt.init(params),
                  "batch": batch}
        step, args = dryrun.build_case(
            arch, shape, mesh, cfg=cfg, sharding=mode, values=values,
            num_microbatches=micro, dcco_impl=impl)
        collectives.reset_counts()
        grads, _ = step.grads(args[0], args[2])
        counts = {k: dict(v) for k, v in collectives.counts.items()}
        p, _, m = step(*args)
        plain = steps.make_dcco_train_step(
            cfg.replace(remat="full"), de_cfg,
            TrainConfig(global_batch=8), opt, num_microbatches=micro)
        g0, _ = plain.grads(params, batch)
        p0, _, m0 = plain(params, opt.init(params), batch)
        rec = {"params": _whole(p), "grads": _whole(grads),
               "loss": m["loss"].full_tensor(), "plain_params": p0,
               "plain_grads": g0, "plain_loss": m0["loss"],
               "counts": counts}
        if cfg.moe is not None:
            _, aux = dual_encoder.encode(cfg, de_cfg, args[0],
                                         args[2]["view1"])
            _, aux0 = dual_encoder.encode(cfg, de_cfg, params,
                                          batch["view1"])
            rec["aux"] = {k: v.full_tensor() for k, v in aux.items()}
            rec["plain_aux"] = aux0
        out["train"][f"{arch}/{mode}" + (
            "" if impl == "fused" else f"/{impl}")] = rec

    arch = "tinyllama-1.1b"
    cfg = get_config(arch, smoke=True)
    _, (tp_params, _, tp_batch) = dryrun.build_case(
        arch, shape, mesh, cfg=cfg, values={
            "params": inp["train"][arch]["params"],
            "batch": inp["train"][arch]["batch"]})
    tokens = tp_batch["view1"]["tokens"]
    tower = tp_params["tower"]
    out["knobs"] = {name: transformer.forward(c, tower, tokens).full_tensor()
                    for name, c in (
                        ("plain", cfg),
                        ("act_shard_axes", cfg.replace(
                            act_shard_axes=("data", "model"))),
                        ("fsdp_model_size", cfg.replace(fsdp_model_size=2)))}
    return out


def task_dryrun_serve(inp):
    """The dry run's serving programs with real values on the (2, 2)
    production mesh of the world, beside the unsharded port: prefill and
    two decode steps, the cache laid out by the dry run's decode rules
    between steps (TinyLlama at batch 1, the cache's slots split over
    "data" and a sliding window of 8 whose ring wraps, and at batch 4,
    rows over "data" and slots over "model"; DeepSeek-V2-Lite's MLA, the
    absorbed decode, at batch 4 and 1; Zamba2's Mamba2 hybrid and xLSTM
    at batch 4): the logits of each step and the cache after the last;
    and the two recurrent towers' forward."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun, inputs as inp_lib
    from repro_torch.launch import mesh as mesh_lib, steps
    from repro_torch.models import transformer

    mesh = mesh_lib.make_production_mesh(ranks_per_host=2)
    out = {"serve": {}, "forward": {}}
    for key, (arch, b, prompt, window) in inp["serve_cases"].items():
        cfg = get_config(arch, smoke=True).replace(sliding_window=window)
        tower, toks = inp["towers"][arch], inp["tokens"][:b]
        total = prompt + 2
        pcfg = cfg.replace(attn_impl="blockwise")
        step, args = dryrun.build_case(
            arch, inp_lib.InputShape("p", total, b, "prefill"), mesh,
            cfg=cfg, values={"params": tower,
                             "batch": {"tokens": toks[:, :prompt]}})
        logits, cache = step(*args)
        plain_l, plain_c = steps.make_prefill_step(pcfg, total)(
            tower, {"tokens": toks[:, :prompt]})
        rec = {"logits": [logits.full_tensor()], "plain": [plain_l]}
        if cfg.block_pattern != ("attn",) and b > 1:
            out["forward"][arch] = {
                "h": transformer.forward(pcfg, args[0],
                                         args[1]["tokens"]).full_tensor(),
                "plain": transformer.forward(pcfg, tower,
                                             toks[:, :prompt])}
        cache = _whole(cache)
        for t in range(prompt, total):
            tok = {"tokens": toks[:, t:t + 1]}
            step, args = dryrun.build_case(
                arch, inp_lib.InputShape("d", total, b, "decode"), mesh,
                cfg=cfg, values={"params": tower, "cache": cache,
                                 "batch": tok})
            logits, cache = step(*args)
            cache = _whole(cache)
            plain_l, plain_c = steps.make_serve_step(pcfg)(tower, plain_c,
                                                          tok)
            rec["logits"].append(logits.full_tensor())
            rec["plain"].append(plain_l)
        rec["cache"], rec["plain_cache"] = cache, plain_c
        out["serve"][key] = rec

    return out


TASKS = {"rounds": task_rounds, "engine": task_engine,
         "losses": task_losses, "step": task_step, "corpus": task_corpus,
         "mesh": task_mesh, "layouts": task_layouts, "dryrun": task_dryrun,
         "dryrun_serve": task_dryrun_serve}


def main() -> None:
    import torch.distributed as dist

    from repro_torch.sharding import maybe_initialize_distributed

    torch.set_num_threads(1)
    tasks, d = sys.argv[1].split(","), Path(sys.argv[2])
    if not maybe_initialize_distributed(device="cpu", timeout_s=60.0):
        raise SystemExit("the REPRO_* environment is not set")
    try:
        inputs = torch.load(d / "inputs.pt", weights_only=True)
        out = {t: TASKS[t](inputs[t]) for t in tasks}
        torch.save(out, d / f"out{dist.get_rank()}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
