"""Randomized cross-validation: fp32 device paths vs the fp64 engine.

Property-style sweep over random obstacle fields and physics parameters —
the kind of coverage the reference's fixed golden cases can't give.
"""

import dataclasses

import numpy as np
import pytest

from lbm_tpu.config import LBMParams
from lbm_tpu.diagnostics import total_density
from lbm_tpu.geometry import free_cells_of
from lbm_tpu.runtime import Simulator
from lbm_tpu.validation import run64


def random_case(seed: int):
    rng = np.random.default_rng(seed)
    # include taller-than-wide grids (ny > nx): y is the blocked/sharded
    # axis, so tall aspect ratios stress block counts and halos hardest
    ny = int(rng.choice([16, 32, 64, 96, 128]))
    nx = int(rng.choice([32, 64, 128]))
    params = LBMParams(
        nx,
        ny,
        40,
        10,
        float(rng.uniform(0.05, 0.2)),
        float(rng.uniform(0.0, 0.01)),
        float(rng.uniform(0.5, 1.9)),
    )
    obstacles = rng.random((ny, nx)) < rng.uniform(0.0, 0.15)
    obstacles[:, 0] = obstacles[:, -1] = True  # side walls like the cases
    # keep the body-force row's guard cells meaningful
    if free_cells_of(obstacles) == 0:
        obstacles[:] = False
    return params, obstacles


@pytest.mark.parametrize("seed", range(6))
def test_fp32_tracks_fp64_on_random_cases(seed):
    params, obstacles = random_case(seed)
    res = Simulator(params, obstacles, kernel="reference").run()
    f64, av64 = run64(params, obstacles)

    # av series within the checker tolerance; ignore exact zeros (possible
    # in fully-blocked pathological rows).
    nz = av64 != 0
    if nz.any():
        pct = np.abs((av64[nz] - res.av_vels[nz]) / av64[nz]) * 100
        assert pct.max() < 1.0, (params, pct.max())
    np.testing.assert_allclose(res.f, f64, rtol=5e-4, atol=1e-7)


def random_wall_case(seed: int):
    """Random case with an interior wall segment at/near the body-force
    row (rows ny-4 .. ny-2) — the geometry most likely to break the
    accelerate-gate algebra."""
    rng = np.random.default_rng(seed + 1000)
    ny = int(rng.choice([16, 32, 64]))
    nx = int(rng.choice([32, 64, 128]))
    params = LBMParams(
        nx,
        ny,
        24,
        10,
        float(rng.uniform(0.05, 0.2)),
        float(rng.uniform(0.0, 0.01)),
        float(rng.uniform(0.5, 1.9)),
    )
    obstacles = rng.random((ny, nx)) < rng.uniform(0.0, 0.1)
    obstacles[:, 0] = obstacles[:, -1] = True
    wall_row = int(rng.integers(ny - 4, ny - 1))  # ny-4 .. ny-2
    x0 = int(rng.integers(0, nx // 2))
    x1 = int(rng.integers(nx // 2, nx))
    obstacles[wall_row, x0:x1] = True
    return params, obstacles


# ---------------------------------------------------------------------------
# Randomized sweeps through the SHARDED paths: random geometry (including
# walls landing on shard boundaries and near the body-force row) and
# random 1-D / 2-D mesh shapes must reproduce the single-device run.
# ---------------------------------------------------------------------------


def _mesh_choices(params, two_d: bool):
    if not two_d:
        return [(n,) for n in (2, 4, 8) if params.ny % n == 0
                and params.ny // n >= 8]
    return [
        (py, px) for py, px in ((2, 2), (2, 4), (4, 2), (1, 4), (8, 1))
        if params.ny % py == 0 and params.ny // py >= 3
        and params.nx % px == 0 and params.nx // px >= 2
    ]


@pytest.mark.parametrize("two_d", [False, True], ids=["1d", "2d"])
@pytest.mark.parametrize("seed", range(4))
def test_sharded_random(seed, two_d):
    import jax

    from lbm_tpu.parallel.sharded import (
        ShardedSimulator,
        default_mesh,
        default_mesh_2d,
    )

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices (conftest XLA_FLAGS)")
    params, obstacles = random_wall_case(seed + 200)
    rng = np.random.default_rng(seed)
    choices = _mesh_choices(params, two_d)
    shape = choices[int(rng.integers(len(choices)))]
    mesh = default_mesh(*shape) if len(shape) == 1 else default_mesh_2d(*shape)
    single = Simulator(params, obstacles, kernel="reference").run()
    res = ShardedSimulator(params, obstacles, mesh=mesh).run()
    np.testing.assert_array_equal(res.f, single.f)
    np.testing.assert_allclose(res.av_vels, single.av_vels, rtol=1e-4)


@pytest.mark.parametrize("seed", [1, 3])
def test_mass_conserved_on_random_cases(seed):
    params, obstacles = random_case(seed)
    params = dataclasses.replace(params, accel=0.0)
    res = Simulator(params, obstacles, kernel="reference").run()
    m0 = params.density * params.nx * params.ny
    m1 = total_density(res.f)
    assert abs(m1 - m0) / m0 < 1e-4
