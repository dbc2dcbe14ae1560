# Federated communication: every client -> server payload (phase-1
# statistics, phase-2 deltas) can flow through a Channel (dense / quantized
# / DP-noised / dropout-robust) with wire-bytes accounting.
from repro_torch.comm.accountant import (  # noqa: F401
    GaussianAccountant, gaussian_rho_per_step, zcdp_to_epsilon)
from repro_torch.comm.channel import (  # noqa: F401
    CHANNELS, Channel, ChannelContext, DenseChannel, DPGaussianChannel,
    DropoutChannel, QuantizedChannel, get_channel)
from repro_torch.comm.quantize import (  # noqa: F401
    dequantize, quant_dequant, quant_dequant_clients, quant_dequant_payload,
    quantize)
