"""Multi-device paths (twin of cvsim_tpu.parallel)."""

from cvsim_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    map_fields,
    run_fused_lines_local,
    run_sharded_chain_fused,
    run_sharded_chain_fused_lines,
)
