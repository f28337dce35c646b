"""The Triton step kernel against the jnp reference step, in interpret mode.

Interpret mode runs the kernel body on the CPU, so everything here checks
the kernel's index arithmetic, masking, body force and partial sums, not
its speed.  The compiled kernel is compared with the reference on the
card by ``chip_smoke.py``'s kernel phase (tests marked ``gpu`` below).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbm_tpu.config import CANONICAL_PARAMS, LBMParams
from lbm_tpu.geometry import canonical_obstacles, channel_box, free_cells_of
from lbm_tpu.ops import triton_step
from lbm_tpu.ops.program import make_reference_program
from lbm_tpu.ops.reference import init_cells
from lbm_tpu.runtime import Simulator, resolve_kernel

# One step of the kernel and of the jnp step agree to a few fp32 ulps
# (XLA's CPU backend may contract a*b+c into an FMA where the interpreter
# does not); relative to max|f| that is below 1e-6.
ONE_STEP_RTOL = 1e-6


def _params(ny, nx, **kw):
    return LBMParams(nx, ny, kw.pop("steps", 4), 10, 0.1,
                     kw.pop("accel", 0.005), kw.pop("omega", 1.85))


def _perturbed_f0(params, seed=0):
    f = np.asarray(init_cells(params))
    rng = np.random.default_rng(seed)
    return f * (1.0 + 0.05 * rng.random(f.shape).astype(np.float32))


def _compare(params, obstacles, *, steps=3, tile=(8, 16), seed=0):
    fcinv = np.float32(1.0) / np.float32(free_cells_of(obstacles))
    ref = make_reference_program(params, obstacles, fcinv)
    tri = triton_step.make_triton_program(
        params, obstacles, fcinv, tile=tile, interpret=True
    )
    f0 = jnp.asarray(_perturbed_f0(params, seed))
    cr, ct = ref.init(f0), tri.init(f0)
    ref_step, tri_step = jax.jit(ref.step), jax.jit(tri.step)
    for _ in range(steps):
        cr, av_r = ref_step(cr)
        ct, av_t = tri_step(ct)
        fr, ft = np.asarray(ref.final(cr)), np.asarray(tri.final(ct))
        scale = np.abs(fr).max()
        assert np.abs(ft - fr).max() <= ONE_STEP_RTOL * scale
        np.testing.assert_allclose(float(av_t), float(av_r), rtol=1e-5)
    return fr, ft


@pytest.mark.parametrize("tile", [(8, 16), (4, 32), (2, 8)],
                         ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize(
    "shape", [(16, 32), (20, 36), (13, 10), (24, 130), (7, 5)],
    ids=lambda s: f"{s[0]}x{s[1]}",
)
def test_matches_reference_over_shapes_and_tiles(shape, tile):
    """Power-of-two and ragged grids, tiles larger and smaller than the
    grid: masked tile edges and the periodic wrap must match the jnp
    step."""
    ny, nx = shape
    _compare(_params(ny, nx), channel_box(nx, ny), tile=tile)


def _layout(kind, ny, nx):
    if kind == "open":
        return np.zeros((ny, nx), bool)
    if kind == "channel_box":
        return channel_box(nx, ny)
    if kind == "interior_walls":
        return channel_box(nx, ny, interior_row=ny // 2, interior_col=nx // 3)
    if kind == "wall_on_force_row":
        mask = channel_box(nx, ny)
        mask[ny - 2, : nx // 2] = True
        return mask
    rng = np.random.default_rng(3)
    mask = rng.random((ny, nx)) < 0.15
    mask[:, 0] = mask[:, -1] = True
    return mask


@pytest.mark.parametrize(
    "layout",
    ["open", "channel_box", "interior_walls", "wall_on_force_row",
     "random_walls"],
)
def test_matches_reference_over_obstacle_layouts(layout):
    ny, nx = 24, 40
    _compare(_params(ny, nx), _layout(layout, ny, nx), tile=(8, 16))


@pytest.mark.parametrize(
    "ny,where", [(18, "first row of a tile"), (17, "last row of a tile"),
                 (10, "row 0 of the last tile")],
)
def test_force_row_at_tile_boundaries(ny, where):
    """Row ny-2 (the body force) landing on a tile edge: the kicked values
    are pulled into the neighbouring tiles too."""
    del where
    params = _params(ny, 32, accel=0.05)
    _compare(params, channel_box(32, ny), tile=(4, 16), steps=4)


def test_partial_sums_are_per_tile_masked_speed_sums():
    """parts[i, j] is the sum of |u| over the fluid cells of tile (i, j);
    their total times 1/free_cells is the step's av."""
    ny, nx, tile = 20, 36, (8, 16)
    params = _params(ny, nx)
    obstacles = _layout("random_walls", ny, nx)
    fluid8 = jnp.asarray((~obstacles).astype(np.int8))
    f0 = _perturbed_f0(params, seed=1)
    call = triton_step.triton_step_call(
        ny, nx, np.float32(params.omega), tile=tile, interpret=True
    )
    _, parts = call(jnp.asarray(f0), fluid8, jnp.zeros((9, nx), jnp.float32))
    parts = np.asarray(parts)
    assert parts.shape == (3, 3)  # cdiv(20, 8) x cdiv(36, 16)
    # fp64 |u| of the streamed state (a zero kick: no body force).
    from lbm_tpu.ops.lattice import CX, CY

    tmp = np.stack([np.roll(f0[k].astype(np.float64), (CY[k], CX[k]), (0, 1))
                    for k in range(9)])
    rho = tmp.sum(0)
    ux = (tmp[1] + tmp[5] + tmp[8] - tmp[3] - tmp[6] - tmp[7]) / rho
    uy = (tmp[2] + tmp[5] + tmp[6] - tmp[4] - tmp[7] - tmp[8]) / rho
    speed = np.where(~obstacles, np.hypot(ux, uy), 0.0)
    want = np.zeros((3, 3))
    for i in range(3):
        for j in range(3):
            want[i, j] = speed[i * 8:(i + 1) * 8, j * 16:(j + 1) * 16].sum()
    np.testing.assert_allclose(parts, want, rtol=1e-5)


def test_step_av_is_the_sum_of_the_partials():
    ny, nx = 24, 40
    params = _params(ny, nx)
    obstacles = channel_box(nx, ny)
    fcinv = np.float32(1.0) / np.float32(free_cells_of(obstacles))
    prog = triton_step.make_triton_program(
        params, obstacles, fcinv, tile=(8, 16), interpret=True
    )
    f0 = jnp.asarray(_perturbed_f0(params))
    _, av = prog.step(prog.init(f0))
    _, ref_av = make_reference_program(params, obstacles, fcinv).step(
        (f0, jnp.asarray(~obstacles))
    )
    np.testing.assert_allclose(float(av), float(ref_av), rtol=1e-6)


@pytest.mark.parametrize(
    "case,tile", [("128x128", triton_step.DEFAULT_TILE), ("128x256", (8, 128))]
)
def test_golden_prefix_triton(case, tile):
    """The kernel reproduces the vendored fp64 golden prefix (200 steps)."""
    import pathlib

    steps = 200
    golden = np.loadtxt(
        pathlib.Path(__file__).parent / "goldens"
        / f"{case}.fp64gen_av_vels.dat", usecols=[1],
    )[:steps]
    params = dataclasses.replace(CANONICAL_PARAMS[case], max_iters=steps)
    obstacles = canonical_obstacles(case)
    fcinv = np.float32(1.0) / np.float32(free_cells_of(obstacles))
    prog = triton_step.make_triton_program(
        params, obstacles, fcinv, tile=tile, interpret=True
    )

    @jax.jit
    def run(f0):
        return jax.lax.scan(lambda c, _: prog.step(c), prog.init(f0), None,
                            length=steps)[1]

    av = np.asarray(run(init_cells(params)))
    pct = np.abs((golden - av) / golden) * 100
    assert np.isfinite(av).all()
    assert pct.max() < 0.2, f"max diff {pct.max():.4f}% at {pct.argmax()}"


@pytest.fixture
def interpret_triton(monkeypatch):
    """Route Simulator's 'triton' program through interpret mode."""
    monkeypatch.setattr(
        triton_step, "make_triton_program",
        functools.partial(triton_step.make_triton_program, interpret=True),
    )


@pytest.mark.parametrize("readback", ["state", "fields"])
def test_simulator_runs_the_kernel(interpret_triton, readback):
    params = dataclasses.replace(_params(16, 64), max_iters=6)
    obstacles = channel_box(64, 16, interior_row=7)
    tri = Simulator(params, obstacles, kernel="triton").run(readback=readback)
    ref = Simulator(params, obstacles, kernel="reference").run(
        readback=readback
    )
    np.testing.assert_allclose(tri.av_vels, ref.av_vels, rtol=1e-5)
    if readback == "state":
        np.testing.assert_allclose(tri.f, ref.f, rtol=1e-5, atol=1e-7)
    else:
        # The payload travels as float16: one fp32 ulp apart can round to
        # neighbouring fp16 values (the fields-vs-state test's bounds).
        np.testing.assert_allclose(tri.fields, ref.fields, rtol=1.1e-3,
                                   atol=1e-6)


def test_kernel_choice():
    assert resolve_kernel("auto", "gpu") == "triton"
    assert resolve_kernel("auto", "cpu") == "reference"
    assert resolve_kernel("reference", "gpu") == "reference"
    assert resolve_kernel("triton", "cpu") == "triton"
    with pytest.raises(ValueError, match="kernel must be one of"):
        resolve_kernel("fused", "gpu")
    params = _params(16, 32)
    assert Simulator(params, channel_box(32, 16)).kernel == "reference"


def test_explicit_kernel_on_cpu_without_interpret_raises():
    """No quiet fallback: asking for the GPU kernel where there is no GPU
    is an error, not a silent switch to the jnp step or to interpret
    mode."""
    params = dataclasses.replace(_params(16, 32), max_iters=2)
    sim = Simulator(params, channel_box(32, 16), kernel="triton")
    with pytest.raises(ValueError, match="interpret"):
        sim.run()


@pytest.mark.parametrize("tile", [(6, 16), (8, 0), (8, 24)])
def test_rejects_non_power_of_two_tiles(tile):
    with pytest.raises(ValueError, match="powers of two"):
        triton_step.triton_step_call(16, 32, 1.85, tile=tile)


@pytest.mark.parametrize(
    "shape", [(1024, 1024), (200, 130)], ids=lambda s: f"{s[0]}x{s[1]}"
)
def test_lowers_to_one_triton_call_for_cuda(shape):
    """Lowered for CUDA (no card needed), one step is one Triton kernel
    over the expected grid, reading f and the int8 mask."""
    ny, nx = shape
    params = _params(ny, nx)
    obstacles = channel_box(nx, ny)
    prog = triton_step.make_triton_program(params, obstacles, np.float32(1e-3))
    fn = jax.jit(lambda f, m: prog.step(prog.init(f, m)))
    exported = jax.export.export(
        fn,
        platforms=["cuda"],
        disabled_checks=[
            jax.export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")
        ],
    )(jax.ShapeDtypeStruct((9, ny, nx), jnp.float32),
      jax.ShapeDtypeStruct((ny, nx), jnp.bool_))
    text = exported.mlir_module()
    assert text.count("__gpu$xla.gpu.triton") == 1
    ty, tx = triton_step.DEFAULT_TILE
    assert f"grid_x = {-(-ny // ty)} : i32" in text
    assert f"grid_y = {-(-nx // tx)} : i32" in text
    assert f"tensor<{ny}x{nx}xi8>" in text


@pytest.mark.gpu
def test_kernel_matches_reference_on_the_card(gpu):
    """On the card, one step from a perturbed state at 1024^2 agrees with
    the jnp step to a few ulps (ONE_STEP_RTOL)."""
    params = dataclasses.replace(CANONICAL_PARAMS["1024x1024"], max_iters=1)
    obstacles = canonical_obstacles("1024x1024")
    f0 = _perturbed_f0(params)
    tri = Simulator(params, obstacles, kernel="triton", device=gpu).run(f0=f0)
    ref = Simulator(params, obstacles, kernel="reference", device=gpu).run(
        f0=f0
    )
    assert np.abs(tri.f - ref.f).max() <= ONE_STEP_RTOL * np.abs(ref.f).max()
    np.testing.assert_allclose(tri.av_vels, ref.av_vels, rtol=1e-5)


def _big_dense_lines(text, threshold=4096):
    # MLIR hex-prints int8/bool literals at ~2 chars/element; legit
    # constants (splats, index vectors) stay far under the threshold.
    return [
        ln for ln in text.splitlines() if "dense" in ln and len(ln) > threshold
    ]


@pytest.mark.parametrize("kernel", ["reference", "triton"])
@pytest.mark.parametrize("readback", ["state", "fields"])
def test_single_chip_run_program_routes_masks_as_operands(
    interpret_triton, kernel, readback
):
    """The full single-device run program (both step implementations,
    both readback modes) must not embed any [ny, nx]-sized mask as an HLO
    literal — the fields payload's fluid mask included (the mask-literal
    rule: an embedded literal makes the compiled module, and its cache
    key, grow with the grid)."""
    params = LBMParams(128, 64, 4, 10, 0.1, 0.005, 1.85)
    obstacles = channel_box(128, 64, interior_row=31)
    sim = Simulator(params, obstacles, kernel=kernel)
    f_spec = jax.ShapeDtypeStruct((9, 64, 128), jnp.float32)
    fn = sim._build(4, readback=readback)
    cspecs = [
        jax.ShapeDtypeStruct(np.asarray(c).shape, np.asarray(c).dtype)
        for c in fn.consts
    ]
    text = fn.lower(f_spec, *cspecs).as_text()
    big = _big_dense_lines(text)
    assert not big, f"{kernel}/{readback} leaked a dense mask literal: {big[0][:120]}"
