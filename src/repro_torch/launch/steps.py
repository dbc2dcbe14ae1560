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

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import utils
from repro_torch.core import cco, dcco
from repro_torch.models import dual_encoder, transformer
from repro_torch.optim import optimizers as opt_lib
from repro_torch.sharding import collectives

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
    batch's, from the moments' mean over the data axes."""
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
    gradients. ``constrain_sharding`` (the reference keeps the
    microbatches' batch dim sharded under XLA's reshape propagation) holds
    by construction here, since a rank only ever holds its shard; it is
    accepted and changes nothing. The per-client loss and an MoE tower's
    aux losses (batch statistics of the routing) are not sharded, and are
    refused with a mesh.
    """
    del constrain_sharding
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
        micro = [utils.tree_map(lambda x: x[i * (n // nm):(i + 1) * (n // nm)],
                                batch) for i in range(nm)]
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
        cache = transformer.init_cache(cfg, tokens.shape[0], max_len,
                                       tokens.device)
        return transformer.prefill(cfg, params, tokens, cache,
                                   patch_embeds=batch.get("patch_embeds"))

    return prefill_step


def make_serve_step(cfg):
    """serve_step(tower_params, cache, batch) -> (logits, cache): one new
    token a sequence, ``batch["tokens"]`` (B, 1), against the cache (which
    it updates in place)."""

    def serve_step(params, cache, batch):
        return transformer.decode_step(cfg, params, cache, batch["tokens"])

    return serve_step
