"""Pure-jnp D2Q9-BGK ops — the readable, any-backend reference path.

Each op mirrors one stage of the reference pipeline (accelerate_flow,
propagate, rebound, collision, av_velocity — ``/root/reference/
d2q9-bgk.c:128-132``) but is written as a whole-grid functional transform:
XLA fuses the stages into a handful of bandwidth-bound passes.  The
reference performs that fusion by hand in its ``timestep`` mega-kernel
(``kernels.cl:56-231``), as does the Triton kernel in
:mod:`lbm_tpu.ops.triton_step` on the GPU; this module is its golden model
and the step everywhere else (CPU, and each shard of the sharded paths).

Array convention: ``f[9, ny, nx]`` float32, speeds-major (SoA — the layout
the reference moved to for coalescing along x).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from lbm_tpu.config import LBMParams
from lbm_tpu.ops.lattice import CX, CY, NSPEEDS, OPPOSITE, WEIGHTS, kick_scale


def uniform_weights(params: LBMParams) -> np.ndarray:
    """The 9 per-speed values of the uniform initial state: w0·rho, w1·rho,
    w2·rho per speed class (``d2q9-bgk.c:529-550``), exact fp32."""
    rho = np.float32(params.density)
    return np.array(
        [rho * np.float32(4.0) / np.float32(9.0)]
        + [rho / np.float32(9.0)] * 4
        + [rho / np.float32(36.0)] * 4,
        dtype=np.float32,
    )


def init_cells(params: LBMParams) -> jax.Array:
    """Uniform initial distributions broadcast over the grid
    (``d2q9-bgk.c:529-550``)."""
    return jnp.broadcast_to(
        uniform_weights(params)[:, None, None],
        (NSPEEDS, params.ny, params.nx),
    ).astype(jnp.float32)


def accel_weights(params: LBMParams) -> tuple[np.float32, np.float32]:
    """Body-force weights w1 = rho·a/9, w2 = rho·a/36 (``kernels.cl:14-15``)."""
    da = np.float32(params.density) * np.float32(params.accel)
    return da / np.float32(9.0), da / np.float32(36.0)


def accelerate_flow(
    f: jax.Array,
    obstacles_row: jax.Array,
    w1: jax.Array | np.float32,
    w2: jax.Array | np.float32,
    row: int,
) -> jax.Array:
    """Apply the body force to grid row ``row`` (= ny-2 in the reference).

    The force fires per cell only when the cell is fluid AND all three
    west-side populations stay strictly positive after the kick
    (``kernels.cl:29-33``).
    """
    r = f[:, row, :]  # [9, nx]
    ok = (
        (~obstacles_row)
        & (r[3] - w1 > 0.0)
        & (r[6] - w2 > 0.0)
        & (r[7] - w2 > 0.0)
    )
    per_speed = [kick_scale(k, w1, w2) for k in range(NSPEEDS)]
    scale = jnp.asarray(
        [0.0 if s is None else s for s in per_speed], dtype=f.dtype
    )
    new_row = r + jnp.where(ok, 1.0, 0.0).astype(f.dtype) * scale[:, None]
    return f.at[:, row, :].set(new_row)


def stream(f: jax.Array) -> jax.Array:
    """Pull-streaming with fully periodic wrap in both axes.

    ``tmp[k][y, x] = f[k][y - cy_k, x - cx_k]`` — the gather the reference
    does with ternary wrap index math (``kernels.cl:91-113``); as a roll XLA
    lowers it to two static slices + concat per axis, staying on device.
    """
    return jnp.stack(
        [
            jnp.roll(f[k], (int(CY[k]), int(CX[k])), axis=(0, 1))
            for k in range(NSPEEDS)
        ]
    )


def macroscopic(tmp: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Density, 1/density and *momentum* (un-normalized velocity).

    The reference works with momentum m = rho·u so only one reciprocal is
    needed per cell ("simplified equations", ``kernels.cl:119-143``).
    Returns ``(rho, rho_inv, mx, my)``.
    """
    rho = jnp.sum(tmp, axis=0)
    rho_inv = 1.0 / rho
    mx = tmp[1] + tmp[5] + tmp[8] - tmp[3] - tmp[6] - tmp[7]
    my = tmp[2] + tmp[5] + tmp[6] - tmp[4] - tmp[7] - tmp[8]
    return rho, rho_inv, mx, my


def equilibrium(
    rho: jax.Array, rho_inv: jax.Array, mx: jax.Array, my: jax.Array
) -> jax.Array:
    """BGK equilibrium in momentum form (``kernels.cl:146-185``).

    feq_k = w_k (rho + 3 e_k·m + (4.5 (e_k·m)^2 - 1.5 |m|^2) / rho)
    which equals the textbook w_k rho (1 + 3 e·u + 4.5 (e·u)^2 - 1.5 u^2)
    with u = m/rho.  Computed per opposite-speed pair (e.m^2 terms shared:
    feq_{k,opp(k)} = shared ± beta) in exactly the structure of the Triton
    kernel's ``collide_planes``, so the two paths agree to the last bits.
    """
    msq = mx * mx + my * my
    half_icsq_rinv = 1.5 * rho_inv
    feq: list[jax.Array] = [None] * NSPEEDS
    feq[0] = jnp.float32(WEIGHTS[0]) * (rho - half_icsq_rinv * msq)
    for a, b, eu in ((1, 3, mx), (2, 4, my), (5, 7, mx + my), (6, 8, my - mx)):
        w = jnp.float32(WEIGHTS[a])
        equ = 3.0 * eu
        shared = w * (rho + half_icsq_rinv * (equ * eu - msq))
        beta = w * equ
        feq[a] = shared + beta
        feq[b] = shared - beta
    return jnp.stack(feq)


def collide(
    tmp: jax.Array,
    fluid: jax.Array,
    omega: jax.Array | np.float32,
) -> tuple[jax.Array, jax.Array]:
    """Fused BGK collision + bounce-back + |u| accumulation.

    Fluid cells relax toward equilibrium; obstacle cells reflect the
    streamed-in populations into their opposite slots (the reference's
    branchless ``lookup`` scatter, ``kernels.cl:187-197``).  Returns
    ``(f_new, tot_u)`` where ``tot_u`` is the *sum* of |u| over fluid cells
    (caller multiplies by 1/free_cells).
    """
    rho, rho_inv, mx, my = macroscopic(tmp)
    feq = equilibrium(rho, rho_inv, mx, my)
    relaxed = tmp + omega * (feq - tmp)
    bounced = tmp[jnp.asarray(OPPOSITE)]
    f_new = jnp.where(fluid[None], relaxed, bounced)
    speed = jnp.sqrt(mx * mx + my * my) * rho_inv
    tot_u = jnp.sum(jnp.where(fluid, speed, 0.0))
    return f_new, tot_u


def make_masked_step_fn(
    params: LBMParams, free_cells_inv: np.float32
) -> Callable[[jax.Array, jax.Array], tuple[jax.Array, jax.Array]]:
    """Build ``step(f, fluid) -> (f_next, av_vel)`` with the fluid mask as
    a runtime OPERAND (bool [ny, nx], True = fluid).

    This is the mask-literal-safe form: jitted drivers pass the mask as an
    argument (``StepProgram.consts``), because a closure-embedded [ny, nx]
    literal makes the compiled module, and its cache key, grow with the
    grid (the mask-literal rule).

    Order per step (reference ``main`` loop, ``d2q9-bgk.c:221-238``):
    accelerate_flow on the read buffer, then the fused
    propagate/rebound/collision/av_velocity pass.
    """
    omega = np.float32(params.omega)
    w1, w2 = accel_weights(params)
    row = params.ny - 2
    fcinv = np.float32(free_cells_inv)

    def step(f: jax.Array, fluid: jax.Array) -> tuple[jax.Array, jax.Array]:
        f = accelerate_flow(f, ~fluid[row], w1, w2, row)
        tmp = stream(f)
        f_new, tot_u = collide(tmp, fluid, omega)
        return f_new, tot_u * fcinv

    return step


def make_step_fn(
    params: LBMParams, obstacles: np.ndarray, free_cells_inv: np.float32
) -> Callable[[jax.Array], tuple[jax.Array, jax.Array]]:
    """Build ``step(f) -> (f_next, av_vel)`` for one timestep — the golden
    single-argument form with the fluid mask embedded in the closure.
    For ad-hoc/test use at ordinary sizes; production drivers route the
    mask as a runtime operand via :func:`make_masked_step_fn` (see the
    mask-literal rule there).
    """
    fluid_host = ~np.asarray(obstacles, dtype=bool)
    masked = make_masked_step_fn(params, free_cells_inv)

    def step(f: jax.Array) -> tuple[jax.Array, jax.Array]:
        return masked(f, jnp.asarray(fluid_host))

    return step
