# The sharded paths' world: the REPRO_* multi-process contract as a
# torch.distributed process group, DeviceMesh constructors with the
# reference's axis names, and the mesh collectives (psum / all_gather
# over an axis, with call and byte counts). The reference's specs.py
# (tensor- and fully-sharded parameter, optimizer-state and cache
# layouts) waits for ROADMAP §1, item 6, part 3, 'Sharded and streaming
# cohorts'.
from repro_torch.sharding.collectives import (  # noqa: F401
    all_gather_tree, axis_index, axis_size, pmean_tree, psum_tree)
from repro_torch.sharding.multihost import (  # noqa: F401
    host_local_to_global, make_corpus_mesh, make_multihost_mesh,
    maybe_initialize_distributed)
