#!/usr/bin/env python3
"""Bring-up check of the whole program on one NVIDIA GPU.

Runs in one process on the first GPU and fails, printing no result, when
JAX finds none.  The phases, in order:

* cases  — the four canonical cases at full length through the CLI's
  ``main()`` (``lbm run``), each checked in-process by the reference
  checker against the vendored fp64 goldens in ``tests/goldens/`` at 1%
  (the ``make check-self`` route);
* giant  — an 8192² grid (f = 2.4 GB, far beyond the 50 MB L2) for 1,000
  steps with fields readback: every value finite, peak device memory
  printed, and total density conserved over a state-readback run;
* kernel — the Triton step kernel compiled at 1024² and 8192² against the
  jnp step, with ``compiled.memory_analysis()``, then the ``gpu``-marked
  tests of the suite;
* ``--four`` — ONLY the four-card phase: ``ShardedSimulator`` over a 1-D
  mesh of 4 and a 2x2 mesh at 8192² global, each against the one-card
  ``Simulator`` on the same grid.

Times printed here are bring-up observations of one run, not benchmarks.
The last line of standard output is the result:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

Usage: ``python chip_smoke.py [--four]``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import pathlib
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent
GOLDENS = REPO / "tests" / "goldens"
CASES = ("128x128", "128x256", "256x256", "1024x1024")
GIANT = 8192
GIANT_STEPS = 1000
MESH_STEPS = 1000

# Kernel vs jnp step on the card, fp32 (PERF.md, "Kernel accuracy").
# One step from the same state: both evaluate the same per-cell expression,
# so they agree to a few ulps (the two compilers may contract a*b+c into an
# FMA differently).  Over 1,000 steps those last-bit differences compound
# through the flow (measured: f 7e-6 apart, av up to 1.8e-4 apart at
# 8192²) while each path drifts ~2.4e-3 from the fp64 engine at 1024²;
# the |u| sum order contributes nothing visible (one step from the same f
# gives the same av on both).  So the 1,000-step av bound sits an order
# below that drift, and the kernel must be as close to the fp64 golden as
# the jnp step is.
ONE_STEP_RTOL = 1e-6
AV_RTOL_1000 = 1e-3
GOLDEN_SLACK = 1.05
# Sharded vs one-card jnp step over 1,000 steps: same per-cell arithmetic,
# only the av reduction is regrouped across cards.
MESH_RTOL = 1e-5


def phases(four: bool) -> tuple[str, ...]:
    return ("four",) if four else ("cases", "giant", "kernel")


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices),
    }})


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def observe(label: str, **values) -> None:
    body = "  ".join(f"{k}={v}" for k, v in values.items())
    print(f"[bring-up observation, not a benchmark] {label}: {body}",
          flush=True)


@contextlib.contextmanager
def compile_seconds():
    """Sum of XLA backend compile durations inside the block."""
    import jax

    total = [0.0]

    def listener(event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            total[0] += duration

    jax.monitoring.register_event_duration_secs_listener(listener)
    try:
        yield total
    finally:
        jax.monitoring.unregister_event_duration_listener(listener)


def golden_max_pct(golden: pathlib.Path, produced: pathlib.Path) -> float:
    import numpy as np

    ref = np.loadtxt(golden, usecols=[1])
    sim = np.loadtxt(produced, usecols=[1])
    return float(np.abs((ref - sim) / ref).max() * 100)


def phase_cases(workdir: pathlib.Path) -> None:
    import numpy as np

    from lbm_tpu import cli
    from lbm_tpu.checker import compare_files
    from lbm_tpu.config import CANONICAL_PARAMS
    from lbm_tpu.geometry import canonical_obstacles, write_obstacle_file

    for case in CASES:
        params = CANONICAL_PARAMS[case]
        d = workdir / case
        d.mkdir()
        params.to_file(d / "input.params")
        write_obstacle_file(d / "obstacles.dat", canonical_obstacles(case))
        out = io.StringIO()
        with compile_seconds() as comp, contextlib.redirect_stdout(out):
            t0 = time.perf_counter()
            rc = cli.main(["run", str(d / "input.params"),
                           str(d / "obstacles.dat"), "--output-dir", str(d)])
            wall = time.perf_counter() - t0
        text = out.getvalue()
        print(text, end="")
        if rc != 0:
            fail(f"{case}: lbm run exited {rc}")
        elapsed = float(text.split("Elapsed time:")[1].split()[0])
        golden_av = GOLDENS / f"{case}.fp64gen_av_vels.dat"
        golden_fs = GOLDENS / f"{case}.fp64gen_final_state.dat"
        has_fs = golden_fs.exists()
        ok = compare_files(
            ref_av_vels=str(golden_av),
            ref_final_state=str(golden_fs) if has_fs else None,
            av_vels=str(d / "av_vels.dat"),
            final_state=str(d / "final_state.dat") if has_fs else None,
            tolerance=1.0,
        )
        pct = golden_max_pct(golden_av, d / "av_vels.dat")
        observe(case, steps=params.max_iters, compile_s=f"{comp[0]:.2f}",
                wall_s=f"{wall:.2f}", run_elapsed_s=f"{elapsed:.4f}",
                mlups=f"{params.nx * params.ny * params.max_iters / elapsed / 1e6:.1f}")
        print(f"checker {case}: av_vels max diff {pct:.4f}% "
              f"({'with' if has_fs else 'without'} final_state) -> "
              f"{'pass' if ok else 'FAIL'}", flush=True)
        if not ok or not np.isfinite(pct):
            fail(f"{case}: checker failed against {golden_av.name}")


def giant_params():
    from lbm_tpu.config import CANONICAL_PARAMS
    from lbm_tpu.geometry import channel_box

    params = dataclasses.replace(
        CANONICAL_PARAMS["1024x1024"], nx=GIANT, ny=GIANT,
        max_iters=GIANT_STEPS,
    )
    return params, channel_box(GIANT, GIANT)


def phase_giant() -> None:
    import jax
    import numpy as np

    from lbm_tpu.runtime import Simulator

    params, obstacles = giant_params()
    sim = Simulator(params, obstacles)
    with compile_seconds() as comp:
        sim.compiled(readback="fields")
    res = sim.run(readback="fields")
    peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    observe(f"{GIANT}^2 fields readback ({sim.kernel})", steps=GIANT_STEPS,
            compile_s=f"{comp[0]:.2f}", run_elapsed_s=f"{res.elapsed:.4f}",
            mlups=f"{res.mlups:.1f}", peak_bytes_in_use=peak)
    if not (np.isfinite(res.fields).all() and np.isfinite(res.av_vels).all()):
        fail("non-finite values in the 8192^2 fields run")
    state = sim.run(readback="state")
    mass0 = params.density * params.nx * params.ny
    mass = float(state.f.sum(dtype=np.float64))
    print(f"{GIANT}^2 total density {mass!r} vs initial {mass0!r} "
          f"(rel {abs(mass - mass0) / mass0:.3e}); "
          f"peak_bytes_in_use after state readback "
          f"{jax.devices()[0].memory_stats()['peak_bytes_in_use']}",
          flush=True)
    if not np.isfinite(state.f).all() or abs(mass - mass0) > 1e-5 * mass0:
        fail("8192^2 state not finite or total density not conserved")


def phase_kernel() -> None:
    import numpy as np
    import pytest

    from lbm_tpu.config import CANONICAL_PARAMS
    from lbm_tpu.geometry import canonical_obstacles
    from lbm_tpu.runtime import Simulator

    p1024 = CANONICAL_PARAMS["1024x1024"]
    grids = {"1024x1024": (p1024, canonical_obstacles("1024x1024")),
             f"{GIANT}x{GIANT}": giant_params()}
    for name, (params, obstacles) in grids.items():
        sims = {k: Simulator(params, obstacles, kernel=k)
                for k in ("triton", "reference")}
        exe = {k: s.compiled(GIANT_STEPS, readback="state").executable
               for k, s in sims.items()}
        many = {k: s.run(GIANT_STEPS, readback="state")
                for k, s in sims.items()}
        # One step from the same developed (non-uniform) state.
        f_mid = many["reference"].f
        one = {k: s.run(1, f0=f_mid, readback="state").f
               for k, s in sims.items()}
        d1 = float(np.abs(one["triton"] - one["reference"]).max()
                   / np.abs(one["reference"]).max())
        av_t, av_r = many["triton"].av_vels, many["reference"].av_vels
        dav = float(np.abs((av_t - av_r) / av_r).max())
        print(f"kernel {name}: 1-step max|df|/max|f| = {d1:.3e} "
              f"(bound {ONE_STEP_RTOL:g}); {GIANT_STEPS}-step av rel diff "
              f"= {dav:.3e} (bound {AV_RTOL_1000:g}); memory_analysis: "
              f"{memory_analysis(exe['triton'])}", flush=True)
        if d1 > ONE_STEP_RTOL or dav > AV_RTOL_1000:
            fail(f"kernel {name} differs from the jnp step")
        golden = GOLDENS / f"{name}.fp64gen_av_vels.dat"
        if golden.exists():
            g = np.loadtxt(golden, usecols=[1])[:GIANT_STEPS]
            err = {k: float(np.abs((r.av_vels - g) / g).max())
                   for k, r in many.items()}
            print(f"kernel {name}: {GIANT_STEPS}-step av vs fp64 golden: "
                  f"triton {err['triton']:.3e}, jnp {err['reference']:.3e}",
                  flush=True)
            if err["triton"] > GOLDEN_SLACK * err["reference"]:
                fail(f"kernel {name} is further from the fp64 golden")
        del sims, exe, one, many, f_mid
    # Keep the suite's conftest from pinning JAX to the CPU.
    os.environ["LBM_TEST_PLATFORM"] = "gpu"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      str(REPO / "tests")])
    if rc != 0:
        fail(f"gpu-marked tests exited {rc}")


def memory_analysis(exe) -> str:
    ma = exe.memory_analysis()
    return (f"argument={ma.argument_size_in_bytes} "
            f"output={ma.output_size_in_bytes} temp={ma.temp_size_in_bytes} "
            f"alias={ma.alias_size_in_bytes}")


def phase_four() -> None:
    import jax
    import numpy as np

    from lbm_tpu.parallel.sharded import (
        ShardedSimulator,
        default_mesh,
        default_mesh_2d,
    )
    from lbm_tpu.runtime import Simulator

    if len(jax.devices()) != 4:
        fail(f"--four needs 4 GPUs, JAX found {len(jax.devices())}")
    params, obstacles = giant_params()
    params = dataclasses.replace(params, max_iters=MESH_STEPS)
    one = Simulator(params, obstacles, kernel="reference").run()
    scale = np.abs(one.f).max()
    for label, mesh in (("1-D x4", default_mesh(4)),
                        ("2-D 2x2", default_mesh_2d(2, 2))):
        sim = ShardedSimulator(params, obstacles, mesh=mesh)
        with compile_seconds() as comp:
            sim.compiled()
        res = sim.run()
        df = float(np.abs(res.f - one.f).max() / scale)
        dav = float(np.abs((res.av_vels - one.av_vels) / one.av_vels).max())
        observe(f"{GIANT}^2 sharded {label}", steps=MESH_STEPS,
                compile_s=f"{comp[0]:.2f}", run_elapsed_s=f"{res.elapsed:.4f}",
                mlups=f"{res.mlups:.1f}", vs_one_card_elapsed_s=f"{one.elapsed:.4f}")
        print(f"sharded {label} vs one card: max|df|/max|f| = {df:.3e}, "
              f"av rel diff = {dav:.3e} (bound {MESH_RTOL:g} each)",
              flush=True)
        if df > MESH_RTOL or dav > MESH_RTOL:
            fail(f"sharded {label} differs from the one-card run")
        del sim, res


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args(argv)

    sys.path.insert(0, str(REPO))
    import jax

    from lbm_tpu.utils.profiling import NVIDIA_SMI_QUERY, device_report

    devices = jax.devices()
    if devices[0].platform != "gpu":
        fail(f"no GPU: JAX found {devices[0].platform}")
    report = device_report()
    print(" ".join(NVIDIA_SMI_QUERY))
    for card in report["cards"]:
        print(f"{card['name']}, {card['power_limit']}")
    print(f"platform={report['platform']} device_kind={report['kind']} "
          f"count={report['count']}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        for phase in phases(args.four):
            t0 = time.perf_counter()
            print(f"== phase {phase} ==", flush=True)
            if phase == "cases":
                phase_cases(pathlib.Path(tmp))
            elif phase == "giant":
                phase_giant()
            elif phase == "kernel":
                phase_kernel()
            else:
                phase_four()
            print(f"== phase {phase} passed in "
                  f"{time.perf_counter() - t0:.1f} s ==", flush=True)
    print(result_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
