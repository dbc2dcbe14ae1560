"""Step builders: the fused D-CCO train step (the paper's technique as one
large-batch step), the LM train step, and the prefill and decode steps of
serving; each a plain function of (cfg, ...) over a parameter tree.

Parameters are trees of tensors that never require grad themselves: a
train step takes gradients with ``torch.autograd.grad`` of detached
copies and returns fresh parameters. With a ``mesh`` the D-CCO step is
data-parallel over ``torch.distributed``: each rank takes its shard of the
batch, and the step's collectives are the statistics' all-reduce and one
all-reduce of the parameter gradients over the data axes.
"""
from __future__ import annotations

import itertools
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import utils
from repro_torch.core import cco, dcco
from repro_torch.models import dual_encoder, transformer
from repro_torch.optim import optimizers as opt_lib
from repro_torch.sharding import collectives, dtensor
from repro_torch.sharding import specs as shard_specs

F32 = torch.float32


def _trainable(params):
    """Detached copies of ``params`` (sharing their storage) that require
    grad."""
    return utils.tree_map(lambda x: x.detach().requires_grad_(), params)


def _grads(loss, params):
    """d loss / d params, as a tree of ``params``' structure; a leaf the
    loss does not reach gets zeros, as ``jax.grad`` gives."""
    leaves = utils.tree_leaves(params)
    gs = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
    return utils.tree_map(
        lambda p: (lambda g: torch.zeros_like(p) if g is None else g)(
            next(gs)), params)


def _encoding_std(zf, mesh=None, data_axes=("data",)):
    """Mean per-dimension std of the encodings; over a mesh, of the whole
    batch's, from the moments' mean over the data axes; on DTensor
    encodings, of the rows gathered (each rank on its copy)."""
    if dtensor.is_dtensor(zf):
        return dtensor.replicated_call(_encoding_std, zf)
    if mesh is None:
        return torch.sqrt(zf.var(0, unbiased=False) + 1e-8).mean()
    z = zf.to(F32)
    m = collectives.pmean_tree({"m": z.mean(0), "sq": (z * z).mean(0)},
                               mesh, data_axes)
    return torch.sqrt(torch.clamp(m["sq"] - m["m"] ** 2, min=0.0)
                      + 1e-8).mean()


def make_dcco_train_step(cfg, de_cfg, tcfg, server_opt, mesh=None,
                         data_axes=("data",), num_microbatches: int = 1,
                         constrain_sharding: bool = False):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, with ``batch = {"view1": {leaf: (N, ...)}, "view2":
    {...}}`` and ``server_opt`` an :class:`repro_torch.optim.Optimizer`
    taking the raw gradient. One federated D-CCO round == one step
    (Appendix-A theorem); the client axis is the leading batch dim.
    ``train_step.grads(params, batch) -> (grads, metrics)`` is the step's
    gradient alone.

    ``num_microbatches`` M > 1 runs EXACT microbatched large-batch CCO,
    the paper's statistics-aggregation trick inside the device: phase 1
    takes the five statistics of each microbatch without a gradient and
    averages them; phase 2 takes one gradient for each microbatch of
    L_CCO(local + sg(agg - local)), each tower under
    ``torch.utils.checkpoint`` (only the encodings are kept across the
    loss; a tower's activations are recomputed in the backward, one tower
    at a time), and averages them in f32. By Appendix A their average IS
    the full-batch gradient. It costs one forward more (phase 1) and the
    checkpointed forward's recompute, and holds the activations of one
    microbatch's tower at a time. (A naive microbatched CCO would compute
    small-batch statistics, the degradation the paper exists to avoid.)

    An MoE tower's loss adds ``balance_weight * balance + 1e-4 *
    router_z`` of its two views (``add_aux``, the reference's), at micro 1
    and in each microbatch's phase-2 loss; ``metrics["loss"]`` includes
    it, as the reference's does.

    ``mesh`` (a DeviceMesh over ``data_axes``) makes the step
    data-parallel: ``batch`` is this rank's contiguous shard of the global
    batch (the client axis sharded over the data axes), and every rank
    returns the same parameters. At micro 1 the loss is the shard_map
    D-CCO loss (:mod:`repro_torch.core.dcco`), for ``dcco_impl`` "fused"
    as for "shard_map": over a rank's rows the global batch's fused loss
    IS that loss, in value and gradient (Appendix A); the ranks' gradient
    shares are summed by one all-reduce. At micro M > 1 phase 1's
    statistics are averaged over the ranks too, and so are the ranks'
    gradients. The per-client loss and an MoE tower's aux losses (batch
    statistics of the routing) are not sharded, and are refused with a
    mesh.

    Without a mesh the step also runs as one DTensor program, on DTensor
    parameters, state and batch (``launch/dryrun.py``): the model code
    places what it makes and DTensor inserts the collectives. There
    ``dcco_impl`` "shard_map" runs its loss on each rank's rows over
    ``data_axes`` under ``local_map`` (the encodings' mesh is the mesh),
    and "per_client" holds each client's statistics where its rows are.
    ``constrain_sharding`` then keeps each microbatch's rows sharded as
    the batch's were (the reference's sharding constraint after its
    microbatch reshape): the batch (N, ...) is reshaped to (M, N / M,
    ...) and redistributed to shard its second dim over the mesh axes
    that sharded the first (an all-to-all), where slicing a sharded
    batch would gather it whole. On plain tensors it changes nothing.
    """
    lam = de_cfg.lambda_cco
    clients = 0
    if tcfg.dcco_impl == "per_client":
        clients = tcfg.global_batch // tcfg.samples_per_client
    nm = num_microbatches
    impl = tcfg.dcco_impl
    if mesh is not None:
        collectives.check_mesh(mesh, data_axes)
        if impl == "per_client":
            raise ValueError("dcco_impl 'per_client' needs the whole batch "
                             "on one rank; with a mesh use 'fused' or "
                             "'shard_map'")
        if cfg.moe is not None and cfg.moe.num_experts > 0:
            raise ValueError("an MoE tower's aux losses are statistics of "
                             "the whole batch's routing, which the sharded "
                             "step does not all-reduce; run it without a "
                             "mesh")
        impl = "shard_map"

    def add_aux(loss, aux):
        if cfg.moe is not None and cfg.moe.num_experts > 0:
            loss = loss + cfg.moe.balance_weight * aux["balance"] \
                + 1e-4 * aux["router_z"]
        return loss

    def single_grads(params, batch):
        p = _trainable(params)
        zf, zg, aux = dual_encoder.encode_pair(cfg, de_cfg, p,
                                               batch["view1"], batch["view2"])
        loss = add_aux(dcco.dcco_loss(zf, zg, lam, impl=impl,
                                      clients=clients, mesh=mesh,
                                      data_axes=data_axes), aux)
        grads = _grads(loss, p)
        if mesh is not None:
            grads = collectives.psum_tree(grads, mesh, data_axes)
        return grads, {"loss": loss.detach(),
                       "encoding_std": _encoding_std(zf.detach(), mesh,
                                                     data_axes)}

    def micro_grads(params, batch):
        n = utils.tree_leaves(batch)[0].shape[0]
        if n % nm:
            raise ValueError(f"a batch of {n} does not split into {nm} "
                             f"microbatches")
        if constrain_sharding and dtensor.is_dtensor(
                utils.tree_leaves(batch)[0]):
            micro = _sharded_microbatches(batch, nm)
        else:
            micro = [utils.tree_map(
                lambda x: x[i * (n // nm):(i + 1) * (n // nm)], batch)
                for i in range(nm)]
        # phase 1: the global statistics, forward only
        agg = None
        with torch.no_grad():
            for mb in micro:
                zf, zg, _ = dual_encoder.encode_pair(
                    cfg, de_cfg, params, mb["view1"], mb["view2"])
                st = cco.encoding_stats(zf, zg)
                if agg is None:
                    agg = {k: torch.zeros_like(v) for k, v in st.items()}
                agg = {k: agg[k] + st[k] / nm for k in agg}
            if mesh is not None:
                agg = collectives.pmean_tree(agg, mesh, data_axes)
        # phase 2: a gradient for each microbatch against the combine
        p = _trainable(params)

        def tower(name):
            return lambda v: dual_encoder.encode(cfg, de_cfg, p, v,
                                                 tower=name)

        acc, losses, stds = None, [], []
        for mb in micro:
            zf, aux1 = checkpoint(tower("f"), mb["view1"],
                                  use_reentrant=False)
            zg, aux2 = checkpoint(tower("g"), mb["view2"],
                                  use_reentrant=False)
            local = cco.encoding_stats(zf, zg)
            loss = add_aux(
                cco.cco_loss_from_stats(cco.dcco_combine(local, agg), lam),
                {k: aux1[k] + aux2[k] for k in aux1})
            g = _grads(loss, p)
            with torch.no_grad():
                if acc is None:
                    acc = utils.tree_map(lambda x: x.to(F32) / nm, g)
                else:
                    utils.tree_map(lambda a, x: a.add_(x.to(F32) / nm), acc, g)
            del g
            losses.append(loss.detach())
            stds.append(_encoding_std(zf.detach()))
        metrics = {"loss": torch.stack(losses).mean(),
                   "encoding_std": torch.stack(stds).mean()}
        if mesh is not None:
            acc = collectives.pmean_tree(acc, mesh, data_axes)
            metrics = collectives.pmean_tree(metrics, mesh, data_axes)
        return acc, metrics

    grads_fn = single_grads if nm <= 1 else micro_grads

    def train_step(params, opt_state, batch):
        grads, metrics = grads_fn(params, batch)
        with torch.no_grad():
            updates, opt_state = server_opt.update(grads, opt_state, params)
            del grads
            params = opt_lib.apply_updates(params, updates)
        return params, opt_state, metrics

    train_step.grads = grads_fn
    return train_step


def _sharded_microbatches(batch, nm: int):
    """The ``nm`` microbatches of a DTensor batch, each laid out with its
    rows sharded as the batch's rows were: (N, ...) reshaped to (nm, N /
    nm, ...) and its second dim sharded, an all-to-all. Where nm does not
    split into the rows' blocks (DTensor cannot reshape them so) the
    batch is gathered first and each rank keeps its part of every
    microbatch; a microbatch with fewer rows than the blocks is
    replicated over the mesh axes it cannot fill (XLA would pad it)."""
    from torch.distributed.tensor import Replicate, Shard

    def split(x):
        n, mesh = x.shape[0], x.device_mesh
        rows = [i for i, p in enumerate(x.placements)
                if isinstance(p, Shard) and p.dim == 0]
        # the mesh axes that split a microbatch's rows: the largest
        # product that divides them (the others replicate it)
        keep = max((c for r in range(len(rows) + 1)
                    for c in itertools.combinations(rows, r)
                    if (n // nm) % math.prod(mesh.size(i) for i in c) == 0),
                   key=lambda c: math.prod(mesh.size(i) for i in c))
        pl = [Replicate() if i in rows and i not in keep else
              Shard(p.dim + 1) if isinstance(p, Shard) else p
              for i, p in enumerate(x.placements)]
        if nm % dtensor.shards(x, 0):
            x = dtensor.replicate_dim(x, 0)
        return x.reshape((nm, n // nm) + tuple(x.shape[1:])).redistribute(
            mesh, pl)

    stacked = utils.tree_map(split, batch)
    return [utils.tree_map(lambda x: x[i], stacked) for i in range(nm)]


def make_lm_train_step(cfg, server_opt):
    """The plain next-token LM train step of a dense tower:
    ``step(tower_params, opt_state, {"tokens": (B, S)}) -> (params,
    opt_state, {"loss"})``, the mean NLL of tokens 1..S-1 in f32."""

    def loss_fn(params, tokens):
        h = transformer.forward(cfg, params, tokens[:, :-1])
        logits = transformer.logits_from_hidden(cfg, params, h)
        logp = torch.log_softmax(logits.to(F32), dim=-1)
        nll = -torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
        return nll.mean()

    def step(params, opt_state, batch):
        p = _trainable(params)
        loss = loss_fn(p, batch["tokens"])
        grads = _grads(loss, p)
        with torch.no_grad():
            updates, opt_state = server_opt.update(grads, opt_state, params)
            params = opt_lib.apply_updates(params, updates)
        return params, opt_state, {"loss": loss.detach()}

    return step


def make_prefill_step(cfg, max_len: int):
    """prefill_step(tower_params, batch) -> (last_logits, cache): a fresh
    cache of ``max_len`` positions on the tokens' device, filled with the
    prompt ``batch["tokens"]`` (B, S), after a vision-text tower's
    ``batch["patch_embeds"]`` (B, P, vis_dim) where given."""

    def prefill_step(params, batch):
        tokens = batch["tokens"]
        if dtensor.is_dtensor(tokens):
            cache = sharded_cache(cfg, tokens.shape[0], max_len,
                                  tokens.device_mesh)
        else:
            cache = transformer.init_cache(cfg, tokens.shape[0], max_len,
                                           tokens.device)
        return transformer.prefill(cfg, params, tokens, cache,
                                   patch_embeds=batch.get("patch_embeds"))

    return prefill_step


def _prefill_cache_pspecs(cache, mesh):
    """The layout of what prefill writes into its cache, which XLA gives
    the cache it creates: rows over the data axes and an attention
    cache's kv heads over "model", where they divide; positions
    replicated."""
    data = shard_specs.data_axes(mesh)
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    n_data = math.prod(sizes[a] for a in ((data,) if isinstance(data, str)
                                          else data or ()))

    def rule(path, leaf):
        name = path.rsplit("/", 1)[-1]
        if leaf.ndim == 0 or name == "kv_pos":
            return shard_specs.P()
        b_dim = 1 if path.startswith("layers/") else 0
        parts = [None] * leaf.ndim
        if n_data > 1 and leaf.shape[b_dim] % n_data == 0:
            parts[b_dim] = data
        m = sizes.get("model", 1)
        if name in ("k", "v", "k_scale", "v_scale") and m > 1 \
                and leaf.shape[b_dim + 2] % m == 0:
            parts[b_dim + 2] = "model"
        return shard_specs.P(*parts)

    return shard_specs._map_with_path(rule, cache)


def sharded_cache(cfg, batch: int, max_len: int, mesh):
    """``transformer.init_cache``'s empty cache as DTensors on ``mesh``,
    laid out as prefill's keys and values are (:func:`_prefill_cache_
    pspecs`), each rank making only its block. A leaf's fill is read
    from a one-slot cache on the CPU (every leaf is constant)."""
    from torch.distributed.tensor import DTensor

    shapes = transformer.init_cache(cfg, batch, max_len, "meta")
    fills = transformer.init_cache(cfg, 1, 1, "cpu")
    specs = _prefill_cache_pspecs(shapes, mesh)
    device = torch.device(mesh.device_type)

    def make(leaf, fill, spec):
        local = torch.empty(shard_specs.local_shape(leaf.shape, spec, mesh),
                            dtype=leaf.dtype, device=device)
        local.copy_(fill.reshape(-1)[0])
        return DTensor.from_local(local, mesh, shard_specs.named(mesh, spec),
                                  run_check=False, shape=leaf.shape,
                                  stride=leaf.stride())

    return utils.tree_map(make, shapes, fills, specs)


def make_serve_step(cfg):
    """serve_step(tower_params, cache, batch) -> (logits, cache): one new
    token a sequence, ``batch["tokens"]`` (B, 1), against the cache (which
    it updates in place)."""

    def serve_step(params, cache, batch):
        return transformer.decode_step(cfg, params, cache, batch["tokens"])

    return serve_step
