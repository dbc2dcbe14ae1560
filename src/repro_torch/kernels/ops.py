"""The reference's public kernel entry points (``repro/kernels/ops.py``),
under its names: ``cco_stats`` (the five encoding statistics in one pass)
and ``flash_attention`` (causal or windowed GQA attention).

Each is the port's wrapper itself, with one route: the CUDA kernel on a
CUDA tensor, its plain PyTorch version on a CPU tensor. The reference's
``use_pallas`` switch (its jnp fallback), ``block_n``/``block_d``,
``block_q``/``block_kv`` and the interpret mode have no counterpart.
"""
from repro_torch.kernels.cco_stats import cco_stats
from repro_torch.kernels.flash_attention import flash_attention

__all__ = ["cco_stats", "flash_attention"]
