"""Client-drift correction for local training: FedProx and SCAFFOLD.

On non-IID clients the local loss minimizers disagree, so local steps pull
the cohort's deltas apart ("client drift") and the averaged update both
shrinks and biases. Two standard corrections, both applied inside the
round bodies of :mod:`repro_torch.core.fed_sim`:

**FedProx** (Li et al. 2020) adds a proximal pull toward the broadcast
model to the local objective, ``loss + mu/2 * ||p - p_global||^2``. Its
gradient ``mu * (p - p_global)`` is added analytically in
``fed_sim.client_local_steps`` (``prox_mu``); ``mu = 0`` takes the plain
code path, bit for bit. With one local step the first iterate sits at
``p_global`` and the term vanishes: FedProx bites at ``local_steps > 1``.

**SCAFFOLD** (Karimireddy et al. 2020) corrects each local gradient with
control variates: client ``k`` steps with ``g - c_k + c``, where ``c_k``
estimates the client's own gradient and ``c`` the population's. After the
local run the client refreshes ``c_k`` (option II, from its realised
progress) and ships ``delta c_k`` up; the server folds the aggregate into
``c``.

Slot semantics: the engine's cohorts are sampled, so one variate is kept
per **cohort slot** (K slots), not per underlying client. With full
participation this is exact SCAFFOLD; under sampling it is the
stateless-client approximation. ``sum_k w_k c_k == c`` holds whenever the
round weights are constant across rounds.

The variate deltas are a per-client uplink the size of a model delta, so
they ride the round's :mod:`repro_torch.comm` channel under the
``"variate"`` phase, bytes included. Every variate is f32, on the
parameters' device.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import utils

F32 = torch.float32


class ScaffoldState(NamedTuple):
    """SCAFFOLD control variates.

    ``c``: the server variate, shaped like the params, f32.
    ``c_slots``: one variate per cohort slot, leading axis K, f32.
    """
    c: Any
    c_slots: Any


def scaffold_init(params, num_slots: int) -> ScaffoldState:
    """Zero variates for a cohort of ``num_slots`` clients."""
    c = utils.tree_map(
        lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params)
    c_slots = utils.tree_map(
        lambda p: torch.zeros((num_slots,) + tuple(p.shape), dtype=F32,
                              device=p.device), params)
    return ScaffoldState(c, c_slots)


def scaffold_corrections(state: ScaffoldState):
    """Per-slot gradient corrections ``c - c_k`` (leading axis K), to be
    *added* to each client's local gradient: the SCAFFOLD local step is
    ``y <- y - lr * (g - c_k + c)``."""
    return utils.tree_map(lambda c, ck: c[None] - ck, state.c, state.c_slots)


def scaffold_new_slot_variates(state: ScaffoldState, deltas,
                               client_lr: float, local_steps: int):
    """Option-II refresh from the realised local progress:
    ``c_k+ = c_k - c + (x - y_k) / (L * lr)``, that is, with
    ``delta_k = y_k - x``, ``c_k - c - delta_k / (L * lr)``."""
    inv = 1.0 / (float(local_steps) * float(client_lr))
    return utils.tree_map(lambda ck, c, d: ck - c[None] - inv * d.to(F32),
                          state.c_slots, state.c, deltas)


def scaffold_apply_round(state: ScaffoldState, c_slots_new, agg_dc,
                         participation_mask=None) -> ScaffoldState:
    """Fold one round's variate refresh into the state.

    ``agg_dc`` is the (channel-aggregated) weighted average of the slot
    variate deltas; the server variate absorbs it. A slot whose
    ``participation_mask`` is 0 (dropped by a DropoutChannel) keeps its
    old variate: a client that never reported cannot have refreshed."""
    if participation_mask is not None:
        m = participation_mask.to(F32)

        def keep(new, old):
            mk = m.reshape((-1,) + (1,) * (new.dim() - 1))
            return mk * new + (1 - mk) * old

        c_slots_new = utils.tree_map(keep, c_slots_new, state.c_slots)
    c_new = utils.tree_map(lambda c, d: c + d, state.c, agg_dc)
    return ScaffoldState(c_new, c_slots_new)
