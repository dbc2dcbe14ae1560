"""Meshes and the card's constants.

``make_debug_mesh`` is the reference's small ("data", "model") mesh, here
a ``torch.distributed.device_mesh.DeviceMesh`` over the world that
:func:`repro_torch.sharding.maybe_initialize_distributed` initialized (a
function, never a module-level constant, so importing this module touches
no device and no process group). The reference's TPU production mesh
(``make_production_mesh``) waits with its dry run for ROADMAP §1, item 6,
part 3, 'Sharded and streaming cohorts'.
"""
from __future__ import annotations

from repro_torch.sharding.multihost import init_mesh


def make_debug_mesh(data: int = 1, model: int = 1):
    """A (data, model) mesh with axes ("data", "model") over the whole
    world (data * model ranks); the tests' and the card's world of one is
    ``make_debug_mesh(1)``."""
    return init_mesh((data, model), ("data", "model"))


class HardwareSpec:
    """NVIDIA H100 SXM constants (NVIDIA's data sheet; dense rates, no
    sparsity, at the 700 W power limit) for the bounds that
    ``chip_smoke.py`` and the tools compute. A card set below 700 W runs
    slower under load: print ``nvidia-smi``'s power.limit beside a bound's
    share."""
    NAME = "NVIDIA H100 SXM"
    PEAK_BYTES = 3.35e12            # HBM3 bytes/s
    PEAK_F32 = 67e12                # f32 FLOP/s outside the tensor cores
    PEAK_TF32 = 495e12              # TF32 tensor-core FLOP/s
    PEAK_BF16 = 989e12              # bf16 tensor-core FLOP/s
