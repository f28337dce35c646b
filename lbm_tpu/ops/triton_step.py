"""One D2Q9-BGK timestep as a single Pallas kernel for NVIDIA GPUs (Triton).

The design is the reference's card kernel (``kernels.cl:56-290``): SoA
planes coalesced along x, pull-streaming with periodic wrap by index
arithmetic, collision and bounce-back in registers, and a per-tile partial
sum of |u| that a second, tiny pass adds up.

* The grid is 2-D over ``[ty, tx]`` tiles (powers of two).  Tiles run in
  parallel in no order, so the kernel reads ``f`` and writes a second
  buffer; no tile depends on another's output.
* Each tile writes one partial |u| sum to ``parts[gy, gx]``; XLA sums them
  afterwards.  No atomics, so the result is deterministic.
* The body force on row ``ny - 2`` is applied on load: XLA computes the
  kick of that one row as a ``[9, nx]`` delta beforehand, and every value
  the kernel pulls from row ``ny - 2`` adds it.  (Measured against
  applying the kick to f by XLA before the kernel: faster at 128², equal
  within noise at 1024² and 8192²; PERF.md.)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from lbm_tpu.config import LBMParams
from lbm_tpu.ops.lattice import CX, CY, NSPEEDS, OPPOSITE, WEIGHTS, kick_scale
from lbm_tpu.ops.program import StepProgram
from lbm_tpu.ops.reference import accel_weights, accelerate_flow

# Within ~2% of the fastest tile measured at 128², 1024² and 8192² (PERF.md).
DEFAULT_TILE = (4, 256)


def collide_planes(
    tmp: list[jax.Array], fluid: jax.Array, omega: jax.Array
) -> tuple[list[jax.Array], jax.Array]:
    """BGK collision + bounce-back on the 9 streamed planes of a tile, in
    momentum form per opposite-speed pair and in the same operation order
    as ops/reference.py's ``collide``/``equilibrium``.  Returns the 9
    post-collision planes and |u| masked to the fluid cells."""
    f32 = jnp.float32
    rho = functools.reduce(jnp.add, tmp)
    rho_inv = f32(1.0) / rho
    mx = tmp[1] + tmp[5] + tmp[8] - tmp[3] - tmp[6] - tmp[7]
    my = tmp[2] + tmp[5] + tmp[6] - tmp[4] - tmp[7] - tmp[8]
    msq = mx * mx + my * my
    half_icsq_rinv = f32(1.5) * rho_inv
    feq = [None] * NSPEEDS
    feq[0] = f32(WEIGHTS[0]) * (rho - half_icsq_rinv * msq)
    for a, b, eu in ((1, 3, mx), (2, 4, my), (5, 7, mx + my), (6, 8, my - mx)):
        w = f32(WEIGHTS[a])
        equ = f32(3.0) * eu
        shared = w * (rho + half_icsq_rinv * (equ * eu - msq))
        beta = w * equ
        feq[a] = shared + beta
        feq[b] = shared - beta
    outs = [
        jnp.where(fluid, tmp[k] + omega * (feq[k] - tmp[k]),
                  tmp[int(OPPOSITE[k])])
        for k in range(NSPEEDS)
    ]
    speed = jnp.where(fluid, jnp.sqrt(msq) * rho_inv, f32(0.0))
    return outs, speed


def _step_kernel(f_ref, fluid_ref, kick_ref, out_ref, part_ref, *,
                 ny, nx, ty, tx, omega, kick_row):
    f32 = jnp.float32
    i, j = pl.program_id(0), pl.program_id(1)
    y = i * ty + jax.lax.broadcasted_iota(jnp.int32, (ty, tx), 0)
    x = j * tx + jax.lax.broadcasted_iota(jnp.int32, (ty, tx), 1)
    valid = (y < ny) & (x < nx)
    # Source coordinates of the pull y - cy, x - cx with periodic wrap.
    ysrc = {0: y, 1: jnp.where(y == 0, ny - 1, y - 1),
            -1: jnp.where(y >= ny - 1, 0, y + 1)}
    xsrc = {0: x, 1: jnp.where(x == 0, nx - 1, x - 1),
            -1: jnp.where(x >= nx - 1, 0, x + 1)}

    tmp = []
    for k in range(NSPEEDS):
        ys, xs = ysrc[int(CY[k])], xsrc[int(CX[k])]
        v = plt.load(f_ref.at[k, ys, xs], mask=valid, other=f32(1.0))
        if kick_scale(k, 0.0, 0.0) is not None:
            v = v + plt.load(
                kick_ref.at[k, xs], mask=valid & (ys == kick_row),
                other=f32(0.0),
            )
        tmp.append(v)

    rows, cols = pl.ds(i * ty, ty), pl.ds(j * tx, tx)
    fluid = plt.load(fluid_ref.at[rows, cols], mask=valid, other=0) != 0

    outs, speed = collide_planes(tmp, fluid, f32(omega))
    for k in range(NSPEEDS):
        plt.store(out_ref.at[k, rows, cols], outs[k], mask=valid)
    # Lanes outside the grid loaded fluid = 0, so their speed is 0.
    part_ref[i, j] = jnp.sum(jnp.sum(speed, axis=1))


def _check_tile(tile: tuple[int, int]) -> None:
    for t in tile:
        if t < 1 or t & (t - 1):
            raise ValueError(f"tile sides must be powers of two, got {tile}")


def triton_step_call(
    ny: int,
    nx: int,
    omega: float,
    *,
    tile: tuple[int, int] = DEFAULT_TILE,
    interpret: bool = False,
):
    """``(f, fluid_i8, kick) -> (f_next, parts[gy, gx])``: stream, collide
    and bounce back one step.  ``kick`` (``[9, nx]``) is added on load to
    every value pulled from row ``ny - 2``."""
    _check_tile(tile)
    ty, tx = tile
    grid = (pl.cdiv(ny, ty), pl.cdiv(nx, tx))
    kernel = functools.partial(
        _step_kernel, ny=ny, nx=nx, ty=ty, tx=tx, omega=float(omega),
        kick_row=ny - 2,
    )
    return pl.pallas_call(
        kernel,
        grid=grid,
        out_shape=(
            jax.ShapeDtypeStruct((NSPEEDS, ny, nx), jnp.float32),
            jax.ShapeDtypeStruct(grid, jnp.float32),
        ),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="lbm_step",
    )


def make_triton_program(
    params: LBMParams,
    obstacles: np.ndarray,
    free_cells_inv: np.float32,
    *,
    tile: tuple[int, int] = DEFAULT_TILE,
    interpret: bool = False,
) -> StepProgram:
    """The Triton step as a :class:`StepProgram` (carry ``(f, fluid_i8)``,
    the mask routed as a runtime operand like the jnp program's)."""
    ny, nx = params.ny, params.nx
    row = ny - 2
    w1, w2 = accel_weights(params)
    fcinv = np.float32(free_cells_inv)
    fluid_host = ~np.asarray(obstacles, dtype=bool)
    call = triton_step_call(
        ny, nx, np.float32(params.omega), tile=tile, interpret=interpret
    )

    def init(f, fluid=None):
        if fluid is None:
            fluid = jnp.asarray(fluid_host)
        return (f, fluid.astype(jnp.int8))

    def step(carry):
        f, fluid8 = carry
        r = f[:, row, :]
        kicked = accelerate_flow(r[:, None, :], fluid8[row] == 0, w1, w2, 0)
        f_new, parts = call(f, fluid8, kicked[:, 0, :] - r)
        return (f_new, fluid8), jnp.sum(parts) * fcinv

    return StepProgram(
        init=init,
        step=step,
        final=lambda carry: carry[0],
        consts=(fluid_host,),
    )
