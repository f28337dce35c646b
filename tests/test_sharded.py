"""Sharded (shard_map + ppermute halo exchange) vs single-device equality.

Runs on the 8-virtual-device CPU mesh forced by conftest.
"""

import dataclasses

import jax
import numpy as np
import pytest

from lbm_tpu.config import LBMParams
from lbm_tpu.geometry import channel_box, free_cells_of
from lbm_tpu.parallel.sharded import (
    ShardedSimulator,
    default_mesh,
    default_mesh_2d,
)
from lbm_tpu.runtime import Simulator

PARAMS = LBMParams(128, 64, 30, 10, 0.1, 0.005, 1.85)

MESHES = [(2,), (4,), (8,), (2, 2), (2, 4), (4, 2), (1, 4), (8, 1)]


def _mesh(shape):
    return default_mesh(shape[0]) if len(shape) == 1 else default_mesh_2d(*shape)


def _geometry(kind: str, nx: int, ny: int) -> np.ndarray:
    if kind == "channel_box":
        return channel_box(nx, ny)
    if kind == "periodic_y":
        # No top/bottom walls (the 128x256 case's family): flow wraps
        # around the y ring, across the first and last row shards.
        return channel_box(nx, ny, top_bottom_walls=False)
    if kind == "interior_wall":
        # A row wall and a column wall, both crossing shard boundaries.
        return channel_box(nx, ny, interior_row=13, interior_col=33)
    rng = np.random.default_rng(7)
    mask = rng.random((ny, nx)) < 0.1
    mask[:, 0] = mask[:, -1] = True
    return mask


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices (conftest XLA_FLAGS)")
    return jax.devices()[:8]


@pytest.mark.parametrize(
    "geometry", ["channel_box", "periodic_y", "interior_wall", "random_walls"]
)
@pytest.mark.parametrize(
    "mesh_shape", MESHES, ids=lambda m: "x".join(map(str, m))
)
def test_sharded_matches_single_device(eight_devices, mesh_shape, geometry):
    """1-D and 2-D meshes reproduce the single-device jnp run bitwise."""
    params = dataclasses.replace(PARAMS, ny=32, nx=64, max_iters=15)
    obstacles = _geometry(geometry, params.nx, params.ny)
    single = Simulator(params, obstacles, kernel="reference").run()
    sharded = ShardedSimulator(
        params, obstacles, mesh=_mesh(mesh_shape)
    ).run()
    # Same per-cell ops in the same order -> distributions match bitwise;
    # only the av reduction tree differs (psum of per-shard partials).
    np.testing.assert_array_equal(sharded.f, single.f)
    np.testing.assert_allclose(sharded.av_vels, single.av_vels, rtol=1e-5)


@pytest.mark.parametrize(
    "mesh_shape", [(8,), (8, 1), (4, 2), (2, 2)],
    ids=lambda m: "x".join(map(str, m)),
)
def test_body_force_row_crosses_shards(eight_devices, mesh_shape):
    """Kick row ny-2 sits on the last row shard (three rows thick on the
    8-row meshes); its wake must cross the shard boundaries above it
    identically."""
    params = dataclasses.replace(PARAMS, ny=24, nx=64, max_iters=20)
    obstacles = channel_box(params.nx, params.ny)
    single = Simulator(params, obstacles, kernel="reference").run()
    sharded = ShardedSimulator(
        params, obstacles, mesh=_mesh(mesh_shape)
    ).run()
    np.testing.assert_array_equal(sharded.f, single.f)


@pytest.mark.parametrize(
    "mesh_shape", [(4,), (2, 2)], ids=lambda m: "x".join(map(str, m))
)
def test_sharded_fields_readback(eight_devices, mesh_shape):
    """Sharded fields readback must agree with the state readback
    PER CELL — a plane swap or spatial permutation in the sharded
    gather would leave av/Reynolds (means) unchanged."""
    from lbm_tpu.io import final_state_columns

    params = dataclasses.replace(PARAMS, max_iters=20)
    obstacles = channel_box(PARAMS.nx, PARAMS.ny, interior_row=31)
    sim = ShardedSimulator(params, obstacles, mesh=_mesh(mesh_shape))
    state = sim.run()
    fields = sim.run(readback="fields")
    assert fields.f is None and fields.fields.shape == (4, PARAMS.ny, PARAMS.nx)
    np.testing.assert_array_equal(state.av_vels, fields.av_vels)
    # Spatial per-cell agreement with the fp64 host derivation from the
    # state payload, at fp16-quantization tolerances (same bounds as the
    # single-device test_fields_readback_matches_state).
    ux, uy, speed, pressure = final_state_columns(params, state.f, obstacles)
    np.testing.assert_allclose(fields.fields[0], ux, rtol=1.1e-3, atol=1e-6)
    np.testing.assert_allclose(fields.fields[1], uy, rtol=1.1e-3, atol=1e-6)
    np.testing.assert_allclose(fields.fields[2], speed, rtol=1.1e-3, atol=1e-6)
    np.testing.assert_allclose(fields.fields[3], pressure, rtol=1e-4)
    assert abs(state.reynolds - fields.reynolds) / abs(state.reynolds) < 2e-4


@pytest.mark.parametrize(
    "mesh_arg", [["--shards", "8"], ["--mesh", "4x2"]], ids=["1d", "2d"]
)
def test_bench_sharded_smoke(eight_devices, capsys, mesh_arg):
    """The weak-scaling harness (BASELINE.json configs[4], scaled down)
    runs end-to-end on the virtual mesh and reports per-device MLUPS."""
    import json

    from tools.bench_sharded import main

    rc = main(
        [*mesh_arg, "--ny", "128", "--nx", "128", "--max-iters", "20",
         "--repeats", "1"]
    )
    assert rc == 0
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["unit"] == "MLUPS/device"
    assert payload["shards"] == 8
    assert payload["value"] > 0
    assert payload["device"]["platform"] == "cpu"
    assert np.isfinite(payload["av_last"])


def test_default_mesh_rejects_oversubscription(eight_devices):
    """Requesting more shards than devices must raise, not silently clamp
    to a smaller mesh (the run would report the wrong topology)."""
    with pytest.raises(ValueError, match="only 8 devices"):
        default_mesh(16)
    with pytest.raises(ValueError, match="only 8 devices"):
        default_mesh_2d(4, 4)
    assert default_mesh(8).shape["y"] == 8


@pytest.mark.parametrize(
    "mesh_shape", [(8,), (8, 1)], ids=lambda m: "x".join(map(str, m))
)
def test_rejects_indivisible_grid(eight_devices, mesh_shape):
    params = dataclasses.replace(PARAMS, ny=36)
    obstacles = channel_box(params.nx, params.ny)
    with pytest.raises(ValueError, match="not divisible"):
        ShardedSimulator(params, obstacles, mesh=_mesh(mesh_shape)).compiled()


@pytest.mark.parametrize(
    "mesh_shape,match", [((8,), "3 rows"), ((8, 1), "too thin")],
    ids=["1d", "2d"],
)
def test_rejects_too_thin_shards(eight_devices, mesh_shape, match):
    params = dataclasses.replace(PARAMS, ny=16)
    obstacles = channel_box(params.nx, params.ny)
    with pytest.raises(ValueError, match=match):
        ShardedSimulator(params, obstacles, mesh=_mesh(mesh_shape)).compiled()


@pytest.mark.parametrize("factory", ["make_sharded_run", "make_sharded_2d_run"])
def test_no_factory_embeds_the_mask_as_an_hlo_literal(eight_devices, factory):
    """Both sharded factories pass the fluid mask as a runtime operand
    (_LoweredWithConsts): an embedded dense literal would make the
    compiled module, and its cache key, grow with the grid."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from lbm_tpu.parallel import sharded as sh

    params = dataclasses.replace(PARAMS, ny=64, nx=128, max_iters=4)
    obstacles = channel_box(params.nx, params.ny, interior_row=31)
    fcinv = np.float32(1.0 / free_cells_of(obstacles))
    if factory == "make_sharded_run":
        mesh, spec = default_mesh(4), P(None, sh.AXIS, None)
    else:
        mesh, spec = default_mesh_2d(2, 2), P(None, sh.AXIS, sh.AXIS_X)
    run = getattr(sh, factory)(params, obstacles, fcinv, mesh)
    s = jax.ShapeDtypeStruct(
        (9, params.ny, params.nx), jnp.float32,
        sharding=NamedSharding(mesh, spec),
    )
    lowered = run.lower(s)
    assert hasattr(lowered, "_consts"), "factory must route consts"
    text = lowered._lowered.as_text()
    # MLIR hex-prints int8/bool literals at ~2 chars per element, so the
    # threshold must be far below elements*chars: an embedded 64x128 mask
    # prints as a ~16k-char dense<"0x..."> line.  Legit constants here are
    # splats or tiny index vectors (< 1k).
    big = [ln for ln in text.splitlines() if "dense" in ln and len(ln) > 4096]
    assert not big, f"dense mask literal leaked: {big[0][:120]}"
