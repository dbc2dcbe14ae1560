# The sharded paths' world: the REPRO_* multi-process contract as a
# torch.distributed process group, DeviceMesh constructors with the
# reference's axis names, and the mesh collectives (psum / all_gather
# over an axis, with call and byte counts), and the reference's layout
# rules (specs.py: tensor- and fully-sharded parameter, ZeRO-1
# optimizer-state, batch and cache specs, and their DTensor placements).
from repro_torch.sharding.collectives import (  # noqa: F401
    all_gather_tree, axis_index, axis_size, pmean_tree, psum_tree)
from repro_torch.sharding.multihost import (  # noqa: F401
    host_local_to_global, make_corpus_mesh, make_multihost_mesh,
    maybe_initialize_distributed)
from repro_torch.sharding.specs import (  # noqa: F401
    DATA_AXES, P, PartitionSpec, batch_pspec, cache_pspecs, data_axes, named,
    opt_state_pspecs, param_pspecs)
