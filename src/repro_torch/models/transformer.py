"""Backbone assembly of the text towers: embedding, the dense prologue,
a stack of superblocks, final norm. A superblock is one pass through
``cfg.block_pattern``, whose slots are ``"attn"`` (GQA or MLA attention +
a SwiGLU or MoE FFN, pre-RMSNorm), ``"mamba2"`` (:mod:`.ssm`), ``"mlstm"``
or ``"slstm"`` (:mod:`.xlstm`), each recurrent block pre-RMSNorm with a
residual (zamba2-2.7b: 5 x mamba2 + attn; xlstm-350m: mlstm + slstm).

As in the reference, the parameters of all superblocks are stacked along a
leading layer axis under ``params["layers"]``, one tree ``"b{i}"`` per
pattern slot; the reference's ``lax.scan`` over that axis becomes a
Python loop over the unbound layers, each running its slots in pattern
order. An MoE config's first ``moe.first_k_dense`` layers are the
``params["prologue"]`` list of unstacked blocks with a dense FFN of
``moe.dense_d_ff``; every stacked attention slot then has the MoE FFN
(:mod:`repro_torch.models.moe`). The reference's knobs, off by default:
``cfg.parallel_block`` (PaLM's block: attention and FFN off one norm,
summed, so a tensor-parallel layer closes with one all-reduce),
``cfg.remat == "full"`` (each superblock under ``torch.utils.checkpoint``,
the reference's ``jax.checkpoint`` of its scan body; a round's phase 2,
which runs under ``torch.func.grad``, cannot take it), and the mesh-only
``cfg.act_shard_axes`` (each block's output redistributed to rows sharded
over those axes) and ``cfg.fsdp_model_size`` (each layer's weights
redistributed to their "model" shard at superblock entry). The
reference's ``scan_layers`` and ``layer_chunks`` have no counterpart: the
layers are a Python loop, the form ``scan_layers=False`` takes, and there
is no ``while`` loop out of which a gather could be hoisted. Its untied
unembedding is not ported (no config sets it).

On DTensor parameters and activations (``launch/dryrun.py``, the sharded
step) the tower runs as a DTensor program: the plain tensors it makes
(positions, the MoE losses' zeros) are placed with
:mod:`repro_torch.sharding.dtensor`, a row-parallel product's pending
sums are reduced once where they join the residual stream, the
recurrent mixers run on each rank's rows under ``local_map``, and the
attention and MoE blocks under their own (:mod:`.attention`,
:mod:`.moe`). On plain tensors nothing of this runs.

An MoE, recurrent, vision-text or audio tower's parameters (16B, 2.8B,
1.7B and 3.2B at full width) draw on ``device``, from a generator seeded
by one draw of ``gen``: the CPU could not draw them in the time of a run.
Their parameters therefore depend on the device type; every other
tower's (the dense text towers') are the same on every device.

Public entry points:
  init_params(cfg, gen, device)              -> params
  forward(cfg, params, tokens, patch_embeds, return_aux)
                                             -> hidden (B, P + S, D) [, aux]
  logits_from_hidden(cfg, params, hidden)    -> f32 logits (tied unembed)
  init_cache(cfg, batch, max_len, device)    -> cache
  prefill(cfg, params, tokens, cache, patch_embeds)
                                             -> (last logits (B, V), cache)
  decode_step(cfg, params, cache, token_ids) -> (logits (B, V), cache)

The cache is the reference's tree, ``{"layers": {"b{i}": {leaf: (L,
...)}}, "pos": () int32}`` plus ``"prologue"``, a list of per-layer
caches, with a prologue; the stacked leaves sit on the layer axis as the
parameters do. An attention slot holds a KV cache; a recurrent slot its
O(1) state (Mamba2's conv ring and SSM state, mLSTM's (C, n, m),
sLSTM's (c, n, h, m)), which ignores ``kv_cache_dtype`` as in the
reference. Prefill and decode run without autograd and update the cache
in place, layer by layer through views of the stacked leaves (a
recurrent state is written back with ``copy_``), so no second stacked
copy is made; they return the same dict. The MoE FFN routes a prefill's
tokens in groups of 512 and a decode step's B tokens as one group, as
the reference does (so decode, whose capacity is small, can drop tokens
that a full forward keeps).

Modalities: ``"text"`` and ``"audio_tokens"`` (musicgen-large: codec
token ids, the dense path) read token ids only. A ``"vision_text"`` tower
(internvl2-2b) has ``params["vis_proj"]``, an MLP (vis_dim, d, d) with
bias; ``forward`` and ``prefill`` given ``patch_embeds`` (B, P, vis_dim)
project them, cast them to the model's dtype and prepend them to the
tokens' embeddings, so the sequence has P + S positions, the patches
first. Without ``patch_embeds`` the tower reads the tokens alone (the
text view; ``vis_proj`` then gets no gradient).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import utils
from repro_torch.models import (attention as attn, moe as moe_mod,
                                ssm as ssm_mod, xlstm as xlstm_mod)
from repro_torch.models.common import (F32, dtype_of, embed, embedding_init,
                                       mlp, mlp_init, rmsnorm, rmsnorm_init,
                                       swiglu, swiglu_init, unembed)
from repro_torch.sharding import dtensor

AUX_KEYS = ("balance", "router_z")


def _moe_flags(cfg):
    """Which stacked pattern slots use the MoE FFN (the first_k_dense
    layers are the prologue, so every stacked attn slot is MoE)."""
    return [cfg.moe is not None and cfg.moe.num_experts > 0 and k == "attn"
            for k in cfg.block_pattern]


def _block_init(gen, cfg, kind: str, dtype, device, moe_layer: bool):
    if kind == "attn":
        p = {"ln1": rmsnorm_init(cfg.d_model, device),
             "ln2": rmsnorm_init(cfg.d_model, device),
             "attn": (attn.mla_init if cfg.use_mla else attn.gqa_init)(
                 gen, cfg, dtype, device)}
        if moe_layer:
            p["moe"] = moe_mod.moe_init(gen, cfg.d_model, cfg.moe, dtype,
                                        device)
        else:
            d_ff = cfg.d_ff if cfg.d_ff > 0 else 4 * cfg.d_model
            if cfg.moe is not None and cfg.moe.dense_d_ff > 0:
                d_ff = cfg.moe.dense_d_ff
            p["ffn"] = swiglu_init(gen, cfg.d_model, d_ff, dtype, device)
        return p
    mixer_init = {"mamba2": ssm_mod.mamba2_init,
                  "mlstm": xlstm_mod.mlstm_init,
                  "slstm": xlstm_mod.slstm_init}.get(kind)
    if mixer_init is None:
        raise ValueError(f"unknown block kind {kind}")
    return {"ln1": rmsnorm_init(cfg.d_model, device),
            "mixer": mixer_init(gen, cfg, dtype, device)}


def _ffn(cfg, p, h, group_size: int = 512):
    """The block's FFN: (y, aux), aux the MoE's losses or {}."""
    if "moe" in p:
        return moe_mod.moe_forward(p["moe"], h, cfg.moe, group_size)
    return swiglu(p["ffn"], h), {}


def _add(x, *ys):
    """The residual ``x + y1 (+ y2)``. On DTensors the branches' pending
    row-parallel sums are added first and reduced once (one all-reduce a
    block, or a parallel block), then cast to ``x``'s type."""
    if dtensor.is_dtensor(x):
        return x + dtensor.settle(sum(ys[1:], ys[0]), x.dtype)
    for y in ys:
        x = x + y
    return x


def _mixer(cfg, kind, fn, p, h, state=None):
    """A recurrent mixer ``fn(cfg, p, h[, state])``; on DTensors under
    ``local_map`` on each rank's rows, its weights replicated (the layout
    rules replicate them)."""
    if state is None:
        call = lambda hh, pp: fn(cfg, pp, hh)          # noqa: E731
    else:
        call = lambda hh, pp, st: fn(cfg, pp, hh, st)  # noqa: E731
    if not dtensor.is_dtensor(h):
        return call(h, p) if state is None else call(h, p, state)
    return dtensor.rows_map(call, h, p, state)


_FORWARD = {"mamba2": lambda cfg, p, h: ssm_mod.mamba2_forward(cfg, p, h),
            "mlstm": lambda cfg, p, h: xlstm_mod.mlstm_forward(cfg, p, h)[0],
            "slstm": lambda cfg, p, h: xlstm_mod.slstm_forward(cfg, p, h)[0]}


def _block_forward(cfg, kind: str, p, x, positions):
    """Full-sequence forward of one block: (y, aux)."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == "attn":
        attn_fn = attn.mla_forward if cfg.use_mla else attn.gqa_forward
        a = attn_fn(cfg, p["attn"], h, positions)
        if cfg.parallel_block:
            y, aux = _ffn(cfg, p, h)
            return _add(x, a, y), aux
        x = _add(x, a)
        y, aux = _ffn(cfg, p, rmsnorm(p["ln2"], x, cfg.norm_eps))
        return _add(x, y), aux
    return _add(x, _mixer(cfg, kind, _FORWARD[kind], p["mixer"], h)), {}


def _stacked(make, n: int):
    """``n`` trees from ``make()``, stacked on a leading axis and filled a
    layer at a time, so the stack is the only full copy."""
    first = make()
    out = utils.tree_map(lambda x: x.new_empty((n,) + x.shape), first)
    for i in range(n):
        blk = first if i == 0 else make()
        utils.tree_map(lambda o, x: o[i].copy_(x), out, blk)
    return out


def init_params(cfg, gen, device="cpu") -> Dict[str, Any]:
    """Random parameters from the CPU generator ``gen``, on ``device``
    (an MoE, recurrent, vision-text or audio tower's from a generator on
    ``device``, module docstring); each superblock's leaves stacked on a
    leading axis under ``"layers"`` (``{"b0": slot 0, ...}``, the
    reference's tree), the
    dense prologue under ``"prologue"``, a vision-text tower's patch
    projector under ``"vis_proj"``. On ``device="meta"`` nothing is drawn
    and ``gen`` is not read: the tree of shapes and dtypes alone."""
    dtype = dtype_of(cfg.dtype)
    if torch.device(device).type == "meta":
        gen = None           # shapes only: nothing drawn (models.common)
    elif (cfg.moe is not None or set(cfg.block_pattern) != {"attn"}
            or cfg.modality != "text"):
        gen = utils.generator(
            int(torch.randint(0, 2 ** 62, (), generator=gen)), device)
    params: Dict[str, Any] = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                                device),
        "final_norm": rmsnorm_init(cfg.d_model, device),
    }
    if cfg.modality == "vision_text":
        params["vis_proj"] = mlp_init(
            gen, (cfg.vis_dim, cfg.d_model, cfg.d_model), dtype, bias=True,
            device=device)
    if cfg.num_prologue:
        params["prologue"] = [
            _block_init(gen, cfg, "attn", dtype, device, False)
            for _ in range(cfg.num_prologue)]
    flags = _moe_flags(cfg)
    params["layers"] = _stacked(
        lambda: {f"b{i}": _block_init(gen, cfg, kind, dtype, device,
                                      flags[i])
                 for i, kind in enumerate(cfg.block_pattern)},
        cfg.num_superblocks)
    return params


def _aux_zeros(x):
    return {k: dtensor.replicated(torch.zeros((), dtype=F32, device=x.device),
                                  x) for k in AUX_KEYS}


def _constrain_act(cfg, x):
    """With ``cfg.act_shard_axes``, a DTensor activation redistributed to
    rows sharded over those mesh axes (replicated over the others), the
    reference's sharding constraint; a plain tensor is returned as it
    is (a constraint on one device does nothing)."""
    if cfg.act_shard_axes is None or not dtensor.is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    names = x.device_mesh.mesh_dim_names
    pl = [Shard(0) if n in cfg.act_shard_axes else Replicate()
          for n in names]
    return x if list(x.placements) == pl else x.redistribute(
        x.device_mesh, pl)


def _constrain_fsdp_layer_params(cfg, sp):
    """With ``cfg.fsdp_model_size`` m, each DTensor weight of a layer (2-D
    and up) redistributed to its "model" shard along its largest
    dimension that m divides (replicated over the other mesh axes): FSDP
    storage, gathered by the products a layer at a time. Plain tensors
    are returned as they are."""
    m = cfg.fsdp_model_size
    if not m:
        return sp

    def rule(leaf):
        if not dtensor.is_dtensor(leaf) or leaf.ndim < 2:
            return leaf
        cands = [(leaf.shape[i], i) for i in range(leaf.ndim)
                 if leaf.shape[i] % m == 0 and leaf.shape[i] >= m]
        if not cands:
            return leaf
        from torch.distributed.tensor import Replicate, Shard
        dim = max(cands)[1]
        pl = [Shard(dim) if n == "model" else Replicate()
              for n in leaf.device_mesh.mesh_dim_names]
        return leaf if list(leaf.placements) == pl else leaf.redistribute(
            leaf.device_mesh, pl)

    return utils.tree_map(rule, sp)


def _superblock_forward(cfg, sp, x, positions):
    """Every slot in pattern order; the MoE losses summed over them
    (zeros where a slot has none)."""
    sp = _constrain_fsdp_layer_params(cfg, sp)
    tot = _aux_zeros(x)
    for i, kind in enumerate(cfg.block_pattern):
        x, aux = _block_forward(cfg, kind, sp[f"b{i}"], x, positions)
        x = _constrain_act(cfg, x)
        tot = {k: tot[k] + aux[k] if k in aux else tot[k] for k in tot}
    return x, tot


def _unstack(tree, n: int):
    """The stacked layer tree as ``n`` per-layer trees. ``unbind`` gives
    one backward (a stack) per leaf, where indexing would add n full-size
    gradients of the stacked leaf."""
    parts = [leaf.unbind(0) for leaf in utils.tree_leaves(tree)]
    layers = []
    for i in range(n):
        it = iter([p[i] for p in parts])
        layers.append(utils.tree_map(lambda _: next(it), tree))
    return layers


def _embed_inputs(cfg, params, tokens, patch_embeds):
    """The tokens' embeddings (B, S, D), after a vision-text tower's
    projected ``patch_embeds`` (B, P, vis_dim) where given: (B, P + S,
    D)."""
    x = dtensor.settle(embed(params["embed"], tokens))
    if cfg.modality == "vision_text" and patch_embeds is not None:
        vis = mlp(params["vis_proj"], patch_embeds.to(x.dtype))
        # on DTensors the patches' gradient comes back in their own rows'
        # layout, whatever the concatenation's backward leaves
        x = torch.cat([dtensor.grad_as(vis.to(x.dtype)), x], dim=1)
    return x


def forward(cfg, params, tokens, patch_embeds=None,
            return_aux: bool = False):
    """tokens: (B, S) int -> hidden (B, S, D) after the final norm (B, P +
    S, D with a vision-text tower's ``patch_embeds`` (B, P, vis_dim),
    prepended); with ``return_aux`` also ``{"balance", "router_z"}``, the
    MoE losses summed over the stacked layers (zeros without MoE)."""
    x = _embed_inputs(cfg, params, tokens, patch_embeds)
    positions = dtensor.positions(x, x.shape[1])
    for p in params.get("prologue", []):
        x, _ = _block_forward(cfg, "attn", p, x, positions)
    tot = _aux_zeros(x)
    for sp in _unstack(params["layers"], cfg.num_superblocks):
        if cfg.remat == "full":
            x, aux = checkpoint(_superblock_forward, cfg, sp, x, positions,
                                use_reentrant=False)
        else:
            x, aux = _superblock_forward(cfg, sp, x, positions)
        tot = {k: tot[k] + aux[k] for k in tot}
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return (x, tot) if return_aux else x


def logits_from_hidden(cfg, params, hidden):
    """f32 logits of the tied unembedding (every ported config ties)."""
    return unembed(params["embed"], hidden)


# ------------------------------------------------------------------ cache ---

def _block_cache_init(cfg, kind, batch, max_len, device):
    dtype = dtype_of(cfg.dtype)
    if kind == "attn":
        cache_init = attn.mla_cache_init if cfg.use_mla \
            else attn.gqa_cache_init
        return cache_init(cfg, batch, max_len, dtype, device)
    if kind == "mamba2":
        return ssm_mod.mamba2_cache_init(cfg, batch, dtype, device)
    state_init = {"mlstm": xlstm_mod.mlstm_state_init,
                  "slstm": xlstm_mod.slstm_state_init}[kind]
    return state_init(cfg, batch, device,
                      torch.promote_types(dtype, F32))


def init_cache(cfg, batch: int, max_len: int, device="cpu"):
    """An empty decode cache for ``batch`` sequences of up to ``max_len``
    positions (a ring of ``cfg.sliding_window`` slots with a window)."""
    proto = {f"b{i}": _block_cache_init(cfg, kind, batch, max_len, device)
             for i, kind in enumerate(cfg.block_pattern)}
    n = cfg.num_superblocks
    cache = {"layers": utils.tree_map(
                 lambda v: v.expand((n,) + v.shape).clone(), proto),
             "pos": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.num_prologue:
        cache["prologue"] = [
            _block_cache_init(cfg, "attn", batch, max_len, device)
            for _ in range(cfg.num_prologue)]
    return cache


def _blocks_and_caches(cfg, params, cache):
    """(kind, block params, its cache) for each block in order, prologue
    first; a stacked block's cache is a dict of views of the stacked
    leaves (writes reach them)."""
    n = cfg.num_superblocks
    out = [("attn", p, c) for p, c in zip(params.get("prologue", []),
                                          cache.get("prologue", []))]
    for i, sp in enumerate(_unstack(params["layers"], n)):
        for j, kind in enumerate(cfg.block_pattern):
            c = {k: v[i] for k, v in cache["layers"][f"b{j}"].items()}
            out.append((kind, sp[f"b{j}"], c))
    return out


def _write_state(cache, state):
    for k, v in state.items():
        cache[k].copy_(v)


def _attn_block(cfg, p, x, h, attn_out, group_size: int = 512):
    """The rest of an attention block after its attention ``attn_out``:
    the FFN off ``ln2`` (or, with ``cfg.parallel_block``, off the
    attention's own norm ``h``) and the residuals."""
    if cfg.parallel_block:
        y, _ = _ffn(cfg, p, h, group_size)
        return _add(x, attn_out, y)
    x = _add(x, attn_out)
    y, _ = _ffn(cfg, p, rmsnorm(p["ln2"], x, cfg.norm_eps), group_size)
    return _add(x, y)


_PREFILL = {"mamba2": ssm_mod.mamba2_prefill,
            "mlstm": xlstm_mod.mlstm_forward,
            "slstm": xlstm_mod.slstm_forward}
_DECODE = {"mamba2": ssm_mod.mamba2_decode,
           "mlstm": xlstm_mod.mlstm_decode,
           "slstm": xlstm_mod.slstm_decode}


def _block_prefill(cfg, kind, p, x, positions, cache):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == "attn":
        pre_fn = attn.mla_prefill if cfg.use_mla else attn.gqa_prefill
        y, _ = pre_fn(cfg, p["attn"], h, positions, cache)
        return _attn_block(cfg, p, x, h, y)
    y, state = _mixer(cfg, kind, _PREFILL[kind], p["mixer"], h, cache)
    _write_state(cache, state)
    return _add(x, y)


def _block_decode(cfg, kind, p, x, pos, cache):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == "attn":
        dec_fn = attn.mla_decode if cfg.use_mla else attn.gqa_decode
        y, _ = dec_fn(cfg, p["attn"], h, pos, cache)
        # the decode step's B tokens route as one group
        return _attn_block(cfg, p, x, h, y, group_size=x.shape[0])
    y, state = _mixer(cfg, kind, _DECODE[kind], p["mixer"], h, cache)
    _write_state(cache, state)
    return _add(x, y)


@torch.no_grad()
def prefill(cfg, params, tokens, cache, patch_embeds=None):
    """Run the prompt ``tokens`` (B, S), after a vision-text tower's
    projected ``patch_embeds`` (B, P, vis_dim) where given, filling
    ``cache`` from position 0 (a recurrent slot from its initial state).
    Returns (last-position f32 logits (B, V), cache). A cache shorter than
    the P + S positions keeps the last ones (the attention ring), as the
    reference's does."""
    x = _embed_inputs(cfg, params, tokens, patch_embeds)
    s = x.shape[1]
    positions = dtensor.positions(x, s)
    for kind, p, c in _blocks_and_caches(cfg, params, cache):
        x = _block_prefill(cfg, kind, p, x, positions, c)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    cache["pos"].fill_(s)
    return logits_from_hidden(cfg, params, x[:, -1]), cache


@torch.no_grad()
def decode_step(cfg, params, cache, token_ids):
    """One token a sequence, ``token_ids`` (B, 1), at position
    ``cache["pos"]``. Returns (f32 logits (B, V), cache)."""
    x = dtensor.settle(embed(params["embed"], token_ids))
    pos = cache["pos"]
    for kind, p, c in _blocks_and_caches(cfg, params, cache):
        x = _block_decode(cfg, kind, p, x, pos, c)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_from_hidden(cfg, params, x[:, 0])
    pos.add_(1)
    return logits, cache
