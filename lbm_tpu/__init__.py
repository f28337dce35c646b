"""lbm_tpu — a D2Q9-BGK lattice-Boltzmann engine in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of the
OpenCL/C lid-driven-channel solver in ag14774/OpenCL-Lattice-Boltzmann
(reference mounted at ``/root/reference``): same physics, same file
contracts (``.params`` / obstacle ``.dat`` in, ``av_vels.dat`` /
``final_state.dat`` out, validated by the same checker protocol), designed
for an NVIDIA GPU — one Pallas (Triton) step kernel per timestep, the whole
time loop compiled into a single XLA program on the device, and
multi-device scaling via ``shard_map`` sharding with per-step halo
exchange.
"""

from lbm_tpu.config import CANONICAL_PARAMS, LBMParams
from lbm_tpu.diagnostics import av_velocity, calc_reynolds, total_density
from lbm_tpu.geometry import (
    canonical_obstacles,
    channel_box,
    free_cells_of,
    load_obstacle_file,
    write_obstacle_file,
)
from lbm_tpu.io import (
    read_av_vels,
    read_final_state,
    write_av_vels,
    write_final_state,
)
from lbm_tpu.parallel.sharded import (
    ShardedSimulator,
    default_mesh,
    default_mesh_2d,
)
from lbm_tpu.runtime import (
    RunResult,
    Simulator,
    enable_compile_cache,
    hbm_budget_gib,
    select_device,
    state_readback_fits,
)

__version__ = "0.1.0"

__all__ = [
    "CANONICAL_PARAMS",
    "LBMParams",
    "RunResult",
    "ShardedSimulator",
    "Simulator",
    "av_velocity",
    "calc_reynolds",
    "canonical_obstacles",
    "channel_box",
    "default_mesh",
    "default_mesh_2d",
    "free_cells_of",
    "enable_compile_cache",
    "hbm_budget_gib",
    "load_obstacle_file",
    "read_av_vels",
    "read_final_state",
    "select_device",
    "state_readback_fits",
    "total_density",
    "write_av_vels",
    "write_final_state",
    "write_obstacle_file",
]
