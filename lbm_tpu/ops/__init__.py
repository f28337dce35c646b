"""Device ops: D2Q9 lattice constants, the jnp step, the Triton GPU step."""

from lbm_tpu.ops.lattice import CX, CY, NSPEEDS, OPPOSITE, WEIGHTS
from lbm_tpu.ops.reference import (
    accelerate_flow,
    collide,
    init_cells,
    make_masked_step_fn,
    make_step_fn,
    macroscopic,
    stream,
)

__all__ = [
    "CX",
    "CY",
    "NSPEEDS",
    "OPPOSITE",
    "WEIGHTS",
    "accelerate_flow",
    "collide",
    "init_cells",
    "macroscopic",
    "make_masked_step_fn",
    "make_step_fn",
    "stream",
]
