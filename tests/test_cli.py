"""CLI end-to-end: run -> output files -> checker passes against goldens."""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from lbm_tpu import cli
from lbm_tpu.checker import compare_files
from lbm_tpu.config import CANONICAL_PARAMS


@pytest.fixture()
def small_case(tmp_path):
    """A 128x128 case truncated to 300 iters, written as real input files."""
    params = dataclasses.replace(CANONICAL_PARAMS["128x128"], max_iters=300)
    from lbm_tpu.geometry import canonical_obstacles, write_obstacle_file

    params.to_file(tmp_path / "input.params")
    write_obstacle_file(tmp_path / "obstacles.dat", canonical_obstacles("128x128"))
    return tmp_path


def test_run_epilogue_and_outputs(small_case, capsys):
    rc = cli.main(
        [
            "run",
            str(small_case / "input.params"),
            str(small_case / "obstacles.dat"),
            "--output-dir",
            str(small_case),
        ]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert "==done==" in out
    assert "Reynolds number:" in out
    assert (small_case / "final_state.dat").exists()
    av_lines = (small_case / "av_vels.dat").read_text().splitlines()
    assert len(av_lines) == 300
    assert av_lines[0].startswith("0:\t")


def test_run_then_check_against_golden_prefix(small_case, reference_dir, capsys):
    """Full loop: run 300 steps, validate the av_vels prefix via the
    vendored checker logic (final_state compared against itself since the
    golden is for 40000 iters)."""
    cli.main(
        [
            "run",
            str(small_case / "input.params"),
            str(small_case / "obstacles.dat"),
            "--output-dir",
            str(small_case),
        ]
    )
    capsys.readouterr()
    golden = np.loadtxt(
        reference_dir / "check" / "128x128.av_vels.dat", usecols=[1]
    )[:300]
    truncated = small_case / "golden_av_vels.dat"
    with open(truncated, "w") as fp:
        fp.writelines(f"{i}:\t{v:.12E}\n" for i, v in enumerate(golden))
    ok = compare_files(
        ref_av_vels=str(truncated),
        ref_final_state=str(small_case / "final_state.dat"),
        av_vels=str(small_case / "av_vels.dat"),
        final_state=str(small_case / "final_state.dat"),
        tolerance=1.0,
    )
    assert ok


def test_bench_json_line(small_case, capsys):
    rc = cli.main(
        [
            "bench",
            str(small_case / "input.params"),
            str(small_case / "obstacles.dat"),
            "--max-iters",
            "50",
        ]
    )
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    payload = json.loads(line)
    assert payload["unit"] == "MLUPS"
    assert payload["value"] > 0


def test_bench_rejects_nonpositive_repeats(small_case):
    with pytest.raises(SystemExit, match="--repeats"):
        cli.main(
            [
                "bench",
                str(small_case / "input.params"),
                str(small_case / "obstacles.dat"),
                "--repeats",
                "0",
            ]
        )


def test_run_sharded_flag(small_case, capsys):
    """--shards N drives the multi-device path end-to-end from the CLI."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs virtual devices")
    rc = cli.main(
        [
            "run",
            str(small_case / "input.params"),
            str(small_case / "obstacles.dat"),
            "--output-dir",
            str(small_case / "sharded"),
            "--shards",
            "4",
            "--max-iters",
            "50",
        ]
    )
    assert rc == 0
    assert "==done==" in capsys.readouterr().out
    assert (small_case / "sharded" / "av_vels.dat").exists()


def test_run_mesh_2d_flag(small_case, capsys):
    """--mesh PYxPX drives the 2-D decomposition end-to-end from the CLI
    (VERDICT r2 item 1: the weak-scaling config must be drivable by the
    production command, not only by tools/bench_sharded.py)."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs virtual devices")
    rc = cli.main(
        [
            "run",
            str(small_case / "input.params"),
            str(small_case / "obstacles.dat"),
            "--output-dir",
            str(small_case / "mesh2d"),
            "--mesh",
            "2x2",
            "--max-iters",
            "50",
        ]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert "==done==" in out
    assert "Mesh: 2x2" in out
    assert (small_case / "mesh2d" / "av_vels.dat").exists()


def test_run_mesh_checkpointed(small_case, capsys):
    """--mesh + --checkpoint-dir runs segmented over the 2-D mesh."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs virtual devices")
    rc = cli.main(
        [
            "run",
            str(small_case / "input.params"),
            str(small_case / "obstacles.dat"),
            "--output-dir",
            str(small_case / "meshck"),
            "--mesh",
            "2x2",
            "--max-iters",
            "30",
            "--checkpoint-dir",
            str(small_case / "meshckdir"),
            "--checkpoint-every",
            "10",
        ]
    )
    assert rc == 0
    assert "==done==" in capsys.readouterr().out
    from lbm_tpu import checkpoint as ckpt

    assert ckpt.load(small_case / "meshckdir").step == 30


def test_mesh_flag_validation(small_case):
    base = [
        "run",
        str(small_case / "input.params"),
        str(small_case / "obstacles.dat"),
    ]
    with pytest.raises(SystemExit, match="not both"):
        cli.main(base + ["--mesh", "2x2", "--shards", "2"])
    with pytest.raises(SystemExit, match="--mesh must be AxB"):
        cli.main(base + ["--mesh", "4"])
    with pytest.raises(SystemExit, match="positive"):
        cli.main(base + ["--mesh", "0x2"])
    # The sharded paths run the jnp step only; a kernel request there must
    # fail loudly rather than be silently ignored.
    with pytest.raises(SystemExit, match="--kernel"):
        cli.main(base + ["--shards", "2", "--kernel", "triton"])
    with pytest.raises(SystemExit, match="--kernel"):
        cli.main(base + ["--mesh", "2x2", "--kernel", "triton"])
    with pytest.raises(SystemExit, match="--device"):
        cli.main(base + ["--mesh", "2x2", "--device", "0"])


def test_check_subcommand(small_case, reference_dir, capsys):
    """The `lbm check` subcommand drives the full checker protocol."""
    cli.main(
        [
            "run",
            str(small_case / "input.params"),
            str(small_case / "obstacles.dat"),
            "--output-dir",
            str(small_case),
        ]
    )
    capsys.readouterr()
    # Self-comparison must pass trivially and exercise the CLI wiring.
    rc = cli.main(
        [
            "check",
            "--ref-av-vels-file",
            str(small_case / "av_vels.dat"),
            "--ref-final-state-file",
            str(small_case / "final_state.dat"),
            "--av-vels-file",
            str(small_case / "av_vels.dat"),
            "--final-state-file",
            str(small_case / "final_state.dat"),
        ]
    )
    assert rc == 0
    assert "Both tests passed!" in capsys.readouterr().out


def test_no_av_collection():
    """collect_av_vels=False still produces the correct final state."""
    import dataclasses

    from lbm_tpu.config import CANONICAL_PARAMS
    from lbm_tpu.geometry import canonical_obstacles
    from lbm_tpu.runtime import Simulator

    params = dataclasses.replace(CANONICAL_PARAMS["128x128"], max_iters=20)
    obs = canonical_obstacles("128x128")
    with_av = Simulator(params, obs, kernel="reference").run()
    without = Simulator(
        params, obs, kernel="reference", collect_av_vels=False
    ).run()
    # XLA fuses differently without the av output -> ~1 ulp FMA deltas.
    np.testing.assert_allclose(with_av.f, without.f, rtol=1e-6, atol=1e-9)
    assert (without.av_vels == 0).all()


def test_select_device_out_of_range(monkeypatch):
    from lbm_tpu.runtime import select_device

    with pytest.raises(ValueError, match="out of range"):
        select_device("99")


def test_bare_invocation_defaults_to_run(small_case, capsys):
    """Reference contract: ``d2q9-bgk <paramfile> <obstaclefile>`` with no
    subcommand (``d2q9-bgk.c:876-880``)."""
    rc = cli.main(
        [
            str(small_case / "input.params"),
            str(small_case / "obstacles.dat"),
            "--output-dir",
            str(small_case / "bare"),
            "--max-iters",
            "20",
        ]
    )
    assert rc == 0
    assert "==done==" in capsys.readouterr().out
    assert (small_case / "bare" / "av_vels.dat").exists()


def test_shards_rejects_unsupported_flags(small_case):
    base = [
        "run",
        str(small_case / "input.params"),
        str(small_case / "obstacles.dat"),
        "--shards",
        "2",
    ]
    with pytest.raises(SystemExit, match="--device"):
        cli.main(base + ["--device", "0"])


def test_shards_with_checkpointing(small_case, capsys):
    """--shards + --checkpoint-dir runs segmented over the mesh."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs virtual devices")
    rc = cli.main(
        [
            "run",
            str(small_case / "input.params"),
            str(small_case / "obstacles.dat"),
            "--output-dir",
            str(small_case / "shck"),
            "--shards",
            "2",
            "--max-iters",
            "30",
            "--checkpoint-dir",
            str(small_case / "ckdir"),
            "--checkpoint-every",
            "10",
        ]
    )
    assert rc == 0
    assert "==done==" in capsys.readouterr().out
    from lbm_tpu import checkpoint as ckpt

    assert ckpt.load(small_case / "ckdir").step == 30


def test_run_on_nondefault_device(small_case, capsys):
    """--device N must bind the executable to that device (ADVICE r1: the
    lowering used to pin the default device and then fail at call time)."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs >= 2 devices")
    rc = cli.main(
        [
            "run",
            str(small_case / "input.params"),
            str(small_case / "obstacles.dat"),
            "--output-dir",
            str(small_case / "dev1"),
            "--device",
            "1",
            "--max-iters",
            "20",
        ]
    )
    assert rc == 0
    assert "==done==" in capsys.readouterr().out


def test_fields_readback_matches_state(small_case, tmp_path):
    """readback='fields' must produce byte-identical output files (modulo
    fp32-vs-fp64 derivation rounding within the checker tolerance) and the
    same Reynolds number as the full-state readback."""
    import dataclasses

    from lbm_tpu.config import CANONICAL_PARAMS
    from lbm_tpu.geometry import canonical_obstacles
    from lbm_tpu.io import read_final_state, write_final_state
    from lbm_tpu.runtime import Simulator

    params = dataclasses.replace(CANONICAL_PARAMS["128x128"], max_iters=50)
    obs = canonical_obstacles("128x128")
    sim = Simulator(params, obs, kernel="reference")
    state = sim.run()
    fields = sim.run(readback="fields")
    assert fields.f is None and fields.fields.shape == (4, 128, 128)
    np.testing.assert_array_equal(state.av_vels, fields.av_vels)
    # |u| derived from the float16 payload; its quantization averages out
    # in the Reynolds mean (unbiased rounding over ~16k free cells)
    assert abs(state.reynolds - fields.reynolds) / state.reynolds < 2e-4

    write_final_state(tmp_path / "a.dat", params, state.f, obs)
    write_final_state(tmp_path / "b.dat", params, None, obs, fields=fields.fields)
    a, b = read_final_state(tmp_path / "a.dat"), read_final_state(tmp_path / "b.dat")
    np.testing.assert_array_equal(a[:, :2], b[:, :2])
    # u columns ride the float16 payload (<= 1 ulp16 ~ 1e-3 relative;
    # atol covers fp16-subnormal near-zero components) — they are outside
    # the checked protocol (check.py validates pressure only).
    np.testing.assert_allclose(a[:, 2:5], b[:, 2:5], rtol=1.1e-3, atol=1e-6)
    # pressure is delta-encoded: reconstruction error ~1e-5 relative.
    np.testing.assert_allclose(a[:, 5], b[:, 5], rtol=1e-4)


def test_checker_av_only_mode(tmp_path, capsys):
    """Without a reference final_state (stripped upstream for the big
    cases), the checker validates av_vels alone."""
    a = tmp_path / "a.dat"
    b = tmp_path / "b.dat"
    a.write_text("0:\t1.00E-05\n")
    b.write_text("0:\t1.05E-05\n")  # 5% off
    assert compare_files(ref_av_vels=str(a), av_vels=str(a))
    assert not compare_files(ref_av_vels=str(a), av_vels=str(b))
    capsys.readouterr()
    rc = cli.main(
        ["check", "--ref-av-vels-file", str(a), "--av-vels-file", str(a)]
    )
    assert rc == 0
    assert "av_vels passed!" in capsys.readouterr().out


def test_checker_detects_final_state_mismatch(tmp_path):
    """The final_state leg must actually compare the checked column
    (pressure, col 5): a beyond-tolerance pressure diff fails, a
    within-tolerance one passes.  Guards against a regression that
    self-compares or drops the final_state report entirely (every other
    test feeds identical final_state files)."""
    av = tmp_path / "av.dat"
    av.write_text("0:\t1.00E-05\n")
    ref = tmp_path / "ref_fs.dat"
    bad = tmp_path / "bad_fs.dat"
    close = tmp_path / "close_fs.dat"
    ref.write_text(
        "0 0 0.0E+00 0.0E+00 0.0E+00 3.300E-02 1\n"
        "1 0 1.0E-03 0.0E+00 1.0E-03 3.400E-02 0\n"
    )
    # second row's pressure 5% off -> beyond the 1% tolerance
    bad.write_text(
        "0 0 0.0E+00 0.0E+00 0.0E+00 3.300E-02 1\n"
        "1 0 1.0E-03 0.0E+00 1.0E-03 3.570E-02 0\n"
    )
    # 0.5% off -> within tolerance
    close.write_text(
        "0 0 0.0E+00 0.0E+00 0.0E+00 3.300E-02 1\n"
        "1 0 1.0E-03 0.0E+00 1.0E-03 3.417E-02 0\n"
    )
    common = dict(ref_av_vels=str(av), av_vels=str(av))
    assert not compare_files(
        **common, ref_final_state=str(ref), final_state=str(bad)
    )
    assert compare_files(
        **common, ref_final_state=str(ref), final_state=str(close)
    )
    # un-checked columns (u_x/u_y/|u|) must NOT affect the verdict —
    # the protocol reads usecols [0, 1, 5] only
    ucols = tmp_path / "ucols_fs.dat"
    ucols.write_text(
        "0 0 9.9E+00 9.9E+00 9.9E+00 3.300E-02 1\n"
        "1 0 9.9E+00 9.9E+00 9.9E+00 3.400E-02 0\n"
    )
    assert compare_files(
        **common, ref_final_state=str(ref), final_state=str(ucols)
    )


def test_checker_rejects_asymmetric_final_state_flags(tmp_path):
    """Supplying only one of the two final_state files must fail, not
    silently narrow to an av_vels-only check."""
    a = tmp_path / "a.dat"
    fs = tmp_path / "fs.dat"
    a.write_text("0:\t1.00E-05\n")
    fs.write_text("0 0 0.0E+00 0.0E+00 0.0E+00 3.3E-02 1\n")
    assert not compare_files(
        ref_av_vels=str(a), av_vels=str(a), final_state=str(fs)
    )
    assert not compare_files(
        ref_av_vels=str(a), ref_final_state=str(fs), av_vels=str(a)
    )


def test_checker_empty_series(tmp_path):
    """Two empty av_vels series compare gracefully (no IndexError)."""
    import warnings

    a = tmp_path / "a.dat"
    a.write_text("")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # numpy's empty-input warning
        assert compare_files(ref_av_vels=str(a), av_vels=str(a))


def test_giant_grid_state_readback_warns(monkeypatch):
    """State readback of a grid whose ~3.2x-f peak exceeds the device's
    memory budget must warn BEFORE dispatch; with no budget known (a
    device that reports no bytes_limit, and no LBM_HBM_GIB) the predicate
    does not apply."""
    import dataclasses
    import warnings

    from lbm_tpu import runtime
    from lbm_tpu.config import CANONICAL_PARAMS
    from lbm_tpu.geometry import canonical_obstacles
    from lbm_tpu.runtime import Simulator, state_readback_fits

    monkeypatch.delenv("LBM_HBM_GIB", raising=False)
    assert runtime.hbm_budget_gib() is None
    assert state_readback_fits(65536, 65536)  # no budget known
    # f = 2.25 GiB at 8192^2 and 5.06 GiB at 12288^2.
    assert state_readback_fits(8192, 8192, 12.0)
    assert not state_readback_fits(12288, 12288, 12.0)
    assert state_readback_fits(12288, 12288, 60.0)
    monkeypatch.setenv("LBM_HBM_GIB", "12")
    assert runtime.hbm_budget_gib() == 12.0
    assert not state_readback_fits(12288, 12288)
    # fields mode is exempt (its device payload is 3 fp16 planes):
    # exercise the wiring on a tiny grid by shrinking the budget.
    params = dataclasses.replace(CANONICAL_PARAMS["128x128"], max_iters=4)
    sim = Simulator(params, canonical_obstacles("128x128"), kernel="reference")
    monkeypatch.setenv("LBM_HBM_GIB", "0.0001")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sim.compiled(readback="state")
        sim.compiled(readback="fields")
    msgs = [str(w.message) for w in caught]
    assert any("readback='fields'" in m for m in msgs), msgs
    assert sum("readback='fields'" in m for m in msgs) == 1  # state only


def test_hbm_budget_reads_the_device_limit():
    """The budget comes from the device's reported bytes_limit; a device
    that reports none gives no budget (no assumed memory size)."""
    from lbm_tpu import runtime

    class Dev:
        def __init__(self, stats):
            self._stats = stats

        def memory_stats(self):
            return self._stats

    assert runtime.hbm_budget_gib(Dev({"bytes_limit": 64 * 2**30})) == 64.0
    assert runtime.hbm_budget_gib(Dev(None)) is None
    assert runtime.hbm_budget_gib(Dev({})) is None


def test_invalid_readback_mode_rejected():
    import dataclasses

    from lbm_tpu.config import CANONICAL_PARAMS
    from lbm_tpu.geometry import canonical_obstacles
    from lbm_tpu.runtime import Simulator

    params = dataclasses.replace(CANONICAL_PARAMS["128x128"], max_iters=5)
    sim = Simulator(params, canonical_obstacles("128x128"), kernel="reference")
    with pytest.raises(ValueError, match="readback"):
        sim.run(readback="field")


def test_checker_fails_on_nan_percent_diff(tmp_path):
    """ref==sim==0 at a step yields a NaN %-diff; the reference checker's
    argmax lands on it and fails — NaNs must not be skipped."""
    a = tmp_path / "a.dat"
    fs = tmp_path / "fs.dat"
    a.write_text("0:\t1.00E-05\n1:\t0.00E+00\n")
    fs.write_text("0 0 0.0E+00 0.0E+00 0.0E+00 3.3E-02 1\n")
    assert not compare_files(
        ref_av_vels=str(a),
        ref_final_state=str(fs),
        av_vels=str(a),
        final_state=str(fs),
    )


def test_checker_rejects_mismatched_steps(tmp_path):
    a = tmp_path / "a.dat"
    b = tmp_path / "b.dat"
    fs = tmp_path / "fs.dat"
    a.write_text("0:\t1.0E-05\n1:\t2.0E-05\n")
    b.write_text("0:\t1.0E-05\n")
    fs.write_text("0 0 0.0E+00 0.0E+00 0.0E+00 3.3E-02 1\n")
    assert not compare_files(
        ref_av_vels=str(a),
        ref_final_state=str(fs),
        av_vels=str(b),
        final_state=str(fs),
    )


def test_checker_detects_out_of_tolerance(tmp_path):
    a = tmp_path / "a.dat"
    b = tmp_path / "b.dat"
    fs = tmp_path / "fs.dat"
    a.write_text("0:\t1.00E-05\n")
    b.write_text("0:\t1.05E-05\n")  # 5% off
    fs.write_text("0 0 0.0E+00 0.0E+00 0.0E+00 3.3E-02 1\n")
    assert not compare_files(
        ref_av_vels=str(a),
        ref_final_state=str(fs),
        av_vels=str(b),
        final_state=str(fs),
        tolerance=1.0,
    )
    assert compare_files(
        ref_av_vels=str(a),
        ref_final_state=str(fs),
        av_vels=str(b),
        final_state=str(fs),
        tolerance=10.0,
    )


def test_enable_compile_cache_env_contract(monkeypatch, tmp_path):
    """LBM_COMPILE_CACHE: off-values disable, a path redirects, and the
    first resolution wins for the process (idempotent once-guard) —
    flipping the global XLA cache config mid-process would split one
    run's entries across directories."""
    import jax

    from lbm_tpu import runtime

    prev_dir = jax.config.jax_compilation_cache_dir
    prev_min = jax.config.jax_persistent_cache_min_compile_time_secs
    try:
        # A cache dir the embedding application already configured is
        # respected verbatim (no env, no re-point).
        monkeypatch.setattr(runtime, "_COMPILE_CACHE_STATE", [])
        jax.config.update("jax_compilation_cache_dir", str(tmp_path / "app"))
        monkeypatch.setenv("LBM_COMPILE_CACHE", str(tmp_path / "ignored"))
        assert runtime.enable_compile_cache() == str(tmp_path / "app")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "app")
        jax.config.update("jax_compilation_cache_dir", prev_dir)

        monkeypatch.setattr(runtime, "_COMPILE_CACHE_STATE", [])
        monkeypatch.setenv("LBM_COMPILE_CACHE", "off")
        assert runtime.enable_compile_cache() is None
        assert runtime.enable_compile_cache() is None  # memoized

        monkeypatch.setattr(runtime, "_COMPILE_CACHE_STATE", [])
        target = str(tmp_path / "xla")
        monkeypatch.setenv("LBM_COMPILE_CACHE", target)
        assert runtime.enable_compile_cache() == target
        assert jax.config.jax_compilation_cache_dir == target
        # Once resolved, a different env value must NOT re-point it.
        monkeypatch.setenv("LBM_COMPILE_CACHE", str(tmp_path / "elsewhere"))
        assert runtime.enable_compile_cache() == target
        assert jax.config.jax_compilation_cache_dir == target

        # Default (no env, nothing pre-set): the fixed in-checkout path.
        monkeypatch.setattr(runtime, "_COMPILE_CACHE_STATE", [])
        jax.config.update("jax_compilation_cache_dir", None)
        monkeypatch.delenv("LBM_COMPILE_CACHE")
        assert runtime.enable_compile_cache() == runtime.DEFAULT_COMPILE_CACHE_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", prev_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", prev_min)


def test_default_compile_cache_is_a_gitignored_dir_in_the_checkout():
    from lbm_tpu import runtime

    repo = pathlib.Path(__file__).resolve().parent.parent
    path = pathlib.Path(runtime.DEFAULT_COMPILE_CACHE_DIR)
    assert path.parent == repo
    ignored = (repo / ".gitignore").read_text().split()
    assert f"{path.name}/" in ignored


_CACHE_PROBE = """
import dataclasses, json, jax
import lbm_tpu
from lbm_tpu import runtime
p = dataclasses.replace(lbm_tpu.CANONICAL_PARAMS["128x128"], max_iters=3)
sim = lbm_tpu.Simulator(p, lbm_tpu.canonical_obstacles("128x128"))
sim.run()
print(json.dumps([runtime.enable_compile_cache(),
                  jax.config.jax_compilation_cache_dir]))
"""


@pytest.mark.parametrize("via", ["JAX_COMPILATION_CACHE_DIR", "LBM_COMPILE_CACHE"])
def test_compile_cache_lands_where_the_environment_says(tmp_path, via):
    """In a fresh process, ``JAX_COMPILATION_CACHE_DIR`` wins outright
    (the code sets no other directory, even with LBM_COMPILE_CACHE also
    set), and without it LBM_COMPILE_CACHE places the cache; either way
    the compiled run's entries land there."""
    import json
    import subprocess
    import sys

    target = tmp_path / "cache"
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "LBM_COMPILE_CACHE")}
    env.update(
        JAX_PLATFORMS="cpu",
        JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
        JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="0",
        PYTHONPATH=str(pathlib.Path(__file__).resolve().parent.parent),
    )
    env[via] = str(target)
    if via == "JAX_COMPILATION_CACHE_DIR":
        env["LBM_COMPILE_CACHE"] = str(tmp_path / "not_this")
    out = subprocess.run(
        [sys.executable, "-c", _CACHE_PROBE], env=env, cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    resolved, configured = json.loads(out.stdout.strip().splitlines()[-1])
    assert resolved == configured == str(target)
    assert not (tmp_path / "not_this").exists()
    if via == "JAX_COMPILATION_CACHE_DIR":
        # The code left JAX's own minimum compile time (0 here) alone, so
        # this tiny run's executables were written.
        assert any(target.iterdir())
