"""Sharding of the MBAR solve over a device mesh.

The counterpart of :mod:`pymbar_tpu.parallel`: on a 1-D mesh, u_kn split
along n across the mesh's devices, the per-state reductions and the dd
polish's weight sums combined over it, and bootstrap replicates solved on
the sharded planes; on a 2-D k x n mesh (``mesh_2d``), u_kn split along
both axes, with the float64 Anderson solve (``sharded2d_solve_mbar``) and
the dd solve (``sharded2d_solve_mbar_dd``, K3 and K4 on every block).
"""

from pymbar_tpu_torch.parallel.sharding import (
    Mesh,
    Mesh2D,
    default_mesh,
    mesh_2d,
    shard_dd_planes,
    stream_shard_planes,
    shard_u_kn,
    shard_u_kn_2d,
    sharded2d_core_stats,
    sharded2d_solve_mbar,
    sharded2d_solve_mbar_dd,
    sharded_bootstrap_polish_dd,
    sharded_core_stats,
    sharded_fused_lognum_dd,
    sharded_gram,
    sharded_log_denominator,
    sharded_solve_mbar,
    sharded_solve_mbar_dd,
)

__all__ = [
    "Mesh",
    "Mesh2D",
    "default_mesh",
    "shard_u_kn",
    "sharded_core_stats",
    "sharded_gram",
    "sharded_log_denominator",
    "sharded_solve_mbar",
    "shard_dd_planes",
    "stream_shard_planes",
    "sharded_fused_lognum_dd",
    "sharded_bootstrap_polish_dd",
    "sharded_solve_mbar_dd",
    "mesh_2d",
    "shard_u_kn_2d",
    "sharded2d_core_stats",
    "sharded2d_solve_mbar",
    "sharded2d_solve_mbar_dd",
]
