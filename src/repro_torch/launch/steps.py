"""Step builders: the fused D-CCO train step (the paper's technique as one
large-batch step), the LM train step, and the prefill and decode steps of
serving; each a plain function of (cfg, ...) over a parameter tree.

Parameters are trees of tensors that never require grad themselves: a
train step takes gradients with ``torch.autograd.grad`` of detached
copies and returns fresh parameters. The reference's ``mesh``,
``data_axes`` and ``constrain_sharding`` (the step sharded over a device
mesh) wait for ROADMAP §1, item 6, 'Sharded and streaming cohorts'.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import utils
from repro_torch.core import cco, dcco
from repro_torch.models import dual_encoder, transformer
from repro_torch.optim import optimizers as opt_lib

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


def _encoding_std(zf):
    return torch.sqrt(zf.var(0, unbiased=False) + 1e-8).mean()


def make_dcco_train_step(cfg, de_cfg, tcfg, server_opt,
                         num_microbatches: int = 1):
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
    """
    lam = de_cfg.lambda_cco
    clients = 0
    if tcfg.dcco_impl == "per_client":
        clients = tcfg.global_batch // tcfg.samples_per_client
    nm = num_microbatches

    def add_aux(loss, aux):
        if cfg.moe is not None and cfg.moe.num_experts > 0:
            loss = loss + cfg.moe.balance_weight * aux["balance"] \
                + 1e-4 * aux["router_z"]
        return loss

    def single_grads(params, batch):
        p = _trainable(params)
        zf, zg, aux = dual_encoder.encode_pair(cfg, de_cfg, p,
                                               batch["view1"], batch["view2"])
        loss = add_aux(dcco.dcco_loss(zf, zg, lam, impl=tcfg.dcco_impl,
                                      clients=clients), aux)
        grads = _grads(loss, p)
        return grads, {"loss": loss.detach(),
                       "encoding_std": _encoding_std(zf.detach())}

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
        return acc, {"loss": torch.stack(losses).mean(),
                     "encoding_std": torch.stack(stds).mean()}

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
