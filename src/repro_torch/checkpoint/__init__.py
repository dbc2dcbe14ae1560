"""msgpack checkpoints of tensor trees, in the reference's file format."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    restore_checkpoint,
    restore_checkpoint_flat,
    save_checkpoint,
)
