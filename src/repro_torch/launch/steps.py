"""Step functions for serving: prefill and decode of a dense transformer
tower, each a plain function of (cfg, ...) over the tower's parameters.

The reference's fused D-CCO training step and its LM training step (the
training CLI's ``--mode fused|protocol``) are not ported yet (ROADMAP
§1, 'Serving and training modes').
"""
from __future__ import annotations

from repro_torch.models import transformer


def make_prefill_step(cfg, max_len: int):
    """prefill_step(tower_params, batch) -> (last_logits, cache): a fresh
    cache of ``max_len`` positions on the tokens' device, filled with the
    prompt ``batch["tokens"]`` (B, S)."""

    def prefill_step(params, batch):
        tokens = batch["tokens"]
        cache = transformer.init_cache(cfg, tokens.shape[0], max_len,
                                       tokens.device)
        return transformer.prefill(cfg, params, tokens, cache)

    return prefill_step


def make_serve_step(cfg):
    """serve_step(tower_params, cache, batch) -> (logits, cache): one new
    token a sequence, ``batch["tokens"]`` (B, 1), against the cache (which
    it updates in place)."""

    def serve_step(params, cache, batch):
        return transformer.decode_step(cfg, params, cache, batch["tokens"])

    return serve_step
