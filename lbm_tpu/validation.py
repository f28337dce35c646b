"""Vectorized float64 NumPy reference engine (validation-grade, host-only).

An independent implementation of the same physics used to (a) generate
standalone golden data for the test suite and (b) cross-check the fp32
device paths at high precision.  Mirrors the reference pipeline
(accelerate → pull-stream → collide/bounce-back → masked mean |u|,
``/root/reference/d2q9-bgk.c:128-132``) but shares no code with the jnp or
Triton implementations.  The scalar per-cell model in
``tests/numpy_model.py`` validates THIS module at tiny sizes in turn.
"""

from __future__ import annotations

import numpy as np

from lbm_tpu.config import LBMParams

_EX = np.array([0, 1, 0, -1, 0, 1, -1, -1, 1])
_EY = np.array([0, 0, 1, 0, -1, 1, 1, -1, -1])
_OPP = np.array([0, 3, 4, 1, 2, 7, 8, 5, 6])
_W = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4)


def init_cells64(params: LBMParams) -> np.ndarray:
    f = np.empty((9, params.ny, params.nx), dtype=np.float64)
    f[0] = params.density * 4.0 / 9.0
    f[1:5] = params.density / 9.0
    f[5:9] = params.density / 36.0
    return f


def run64(
    params: LBMParams,
    obstacles: np.ndarray,
    max_iters: int | None = None,
    f0: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Run ``max_iters`` steps in float64; returns ``(f, av_vels)``."""
    if max_iters is None:
        max_iters = params.max_iters
    obstacles = np.asarray(obstacles, bool)
    fluid = ~obstacles
    free_cells = int(fluid.sum())
    f = init_cells64(params) if f0 is None else np.array(f0, np.float64)
    av = np.empty(max_iters, dtype=np.float64)

    w1 = params.density * params.accel / 9.0
    w2 = params.density * params.accel / 36.0
    row = params.ny - 2
    omega = params.omega

    for t in range(max_iters):
        # body force on row ny-2 (positivity-guarded, fluid cells only)
        r = f[:, row, :]
        ok = (
            fluid[row]
            & (r[3] - w1 > 0.0)
            & (r[6] - w2 > 0.0)
            & (r[7] - w2 > 0.0)
        )
        kick = np.where(ok, 1.0, 0.0)
        r[1] += kick * w1
        r[5] += kick * w2
        r[8] += kick * w2
        r[3] -= kick * w1
        r[6] -= kick * w2
        r[7] -= kick * w2

        # pull-stream with periodic wrap
        tmp = np.stack(
            [
                np.roll(f[k], (int(_EY[k]), int(_EX[k])), axis=(0, 1))
                for k in range(9)
            ]
        )

        # macroscopic moments + equilibrium
        rho = tmp.sum(axis=0)
        ux = (tmp[1] + tmp[5] + tmp[8] - tmp[3] - tmp[6] - tmp[7]) / rho
        uy = (tmp[2] + tmp[5] + tmp[6] - tmp[4] - tmp[7] - tmp[8]) / rho
        usq = ux * ux + uy * uy
        eu = _EX[:, None, None] * ux + _EY[:, None, None] * uy
        feq = (
            _W[:, None, None]
            * rho
            * (1.0 + 3.0 * eu + 4.5 * eu * eu - 1.5 * usq)
        )

        relaxed = tmp + omega * (feq - tmp)
        f = np.where(fluid, relaxed, tmp[_OPP])
        av[t] = np.sqrt(usq)[fluid].sum() / free_cells
    return f, av
