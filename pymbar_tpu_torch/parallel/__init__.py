"""Sample-axis (N) sharding of the MBAR solve over a 1-D device mesh.

The counterpart of :mod:`pymbar_tpu.parallel` for the 1-D mesh: u_kn split
along n across the mesh's devices, the per-state reductions and the dd
polish's weight sums combined over it, and bootstrap replicates solved on
the sharded planes.  The 2-D k x n mesh is still to be ported.
"""

from pymbar_tpu_torch.parallel.sharding import (
    Mesh,
    default_mesh,
    shard_dd_planes,
    sharded_bootstrap_polish_dd,
    shard_u_kn,
    sharded_core_stats,
    sharded_fused_lognum_dd,
    sharded_gram,
    sharded_log_denominator,
    sharded_solve_mbar,
    sharded_solve_mbar_dd,
)

__all__ = [
    "Mesh",
    "default_mesh",
    "shard_u_kn",
    "sharded_core_stats",
    "sharded_gram",
    "sharded_log_denominator",
    "sharded_solve_mbar",
    "shard_dd_planes",
    "sharded_fused_lognum_dd",
    "sharded_bootstrap_polish_dd",
    "sharded_solve_mbar_dd",
]
