"""Tooling drift guards: the repo tools must keep working against the
library's current contracts."""

import importlib.util
import pathlib

import numpy as np

from lbm_tpu.config import LBMParams

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_all_golden_series_falls_back_to_vendored(monkeypatch, tmp_path):
    """bench_all's drift gate works without the reference mount: it falls
    back to the vendored fp64 goldens — ALL FOUR full-length since round
    4 — and a truncated vendored series still gates as a loudly-labeled
    prefix (the caller compares the overlapping steps and prints a NOTE
    line; no-silent-caps)."""
    ba = _load("bench_all")
    monkeypatch.setattr(ba, "GOLDEN_DIR", tmp_path / "no_reference")

    for case, steps in (
        ("128x128", 40000), ("128x256", 40000),
        ("256x256", 80000), ("1024x1024", 20000),
    ):
        vendored = ba.golden_series(case, steps)
        assert vendored is not None and vendored.size == steps, case

    # A truncated vendored series (e.g. regenerated short) still gates
    # as a prefix rather than being dropped.
    vend = tmp_path / "vendored"
    vend.mkdir()
    head = np.loadtxt(
        ba.VENDORED_DIR / "1024x1024.fp64gen_av_vels.dat", usecols=[1]
    )[:600]
    from lbm_tpu.io import write_av_vels

    write_av_vels(vend / "1024x1024.fp64gen_av_vels.dat", head)
    monkeypatch.setattr(ba, "VENDORED_DIR", vend)
    prefix = ba.golden_series("1024x1024", 20000)
    assert prefix is not None and 0 < prefix.size < 20000
    # Longer than the run -> wrong case/params: never gate against it.
    assert ba.golden_series("1024x1024", 100) is None
    # Unknown case -> None.
    assert ba.golden_series("7x7", 100) is None


def test_bench_all_golden_series_prefers_reference(reference_dir):
    """With the mount present, the reference's own golden wins."""
    ba = _load("bench_all")
    golden = ba.golden_series("128x128", 40000)
    ref = np.loadtxt(
        reference_dir / "check" / "128x128.av_vels.dat", usecols=[1]
    )
    np.testing.assert_array_equal(golden, ref)


def test_gen_inputs_canonical_max_iters_override(tmp_path):
    """`gen_inputs 1024x1024 --max-iters 600` writes the canonical
    geometry with only max_iters replaced — the `make check-self` prefix
    gate relies on this (a 600-step run's av_vels IS the first 600
    entries of the 20000-step run)."""
    from lbm_tpu.config import CANONICAL_PARAMS, LBMParams
    from lbm_tpu.geometry import canonical_obstacles, load_obstacle_file

    gi = _load("gen_inputs")
    gi.main(["1024x1024", str(tmp_path), "--max-iters", "600"])
    got = LBMParams.from_file(tmp_path / "input_1024x1024.params")
    want = CANONICAL_PARAMS["1024x1024"]
    assert got.max_iters == 600
    assert (got.nx, got.ny, got.density, got.accel, got.omega) == (
        want.nx, want.ny, want.density, want.accel, want.omega
    )
    mask, _ = load_obstacle_file(
        tmp_path / "obstacles_1024x1024.dat", got.nx, got.ny
    )
    np.testing.assert_array_equal(mask, canonical_obstacles("1024x1024"))

    # Without the flag the shipped value is kept.
    gi.main(["128x128", str(tmp_path)])
    assert LBMParams.from_file(tmp_path / "input_128x128.params").max_iters == 40000
