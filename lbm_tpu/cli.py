"""Command-line interface.

Parity target: the reference binary's contract (``/root/reference/
d2q9-bgk.c:876-880``): ``d2q9-bgk <paramfile> <obstaclefile>`` reads the two
input files, runs, prints the canonical 4-line epilogue (``==done==``,
Reynolds number, elapsed + CPU times, ``d2q9-bgk.c:271-275``) and writes
``final_state.dat`` / ``av_vels.dat`` into the working directory.  Device
selection honours ``LBM_DEVICE`` (the ``OCL_DEVICE`` analog).

Extensions over the reference CLI (subcommands):

* ``run``    — the parity contract above, plus ``--output-dir``,
  ``--kernel``, MLUPS/bandwidth reporting and an optional profiler trace.
* ``bench``  — timed run without file output, JSON metric line.
* ``check``  — compare produced outputs against reference data
  (drives :mod:`tools.check`-equivalent logic in-process).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import resource
import sys

from lbm_tpu.config import LBMParams
from lbm_tpu.geometry import load_obstacle_file
from lbm_tpu.io import write_av_vels, write_final_state
from lbm_tpu.runtime import KERNELS, RunResult, Simulator, select_device


def _load_case(params_path: str, obstacles_path: str):
    params = LBMParams.from_file(params_path)
    obstacles, _ = load_obstacle_file(obstacles_path, params.nx, params.ny)
    return params, obstacles


def _epilogue(res: RunResult) -> None:
    """The reference's stdout contract plus perf counters."""
    usage = resource.getrusage(resource.RUSAGE_SELF)
    print("==done==")
    print(f"Reynolds number:\t\t{res.reynolds:.12E}")
    print(f"Elapsed time:\t\t\t{res.elapsed:.6f} (s)")
    print(f"Elapsed user CPU time:\t\t{usage.ru_utime:.6f} (s)")
    print(f"Elapsed system CPU time:\t{usage.ru_stime:.6f} (s)")
    # Perf readout (beyond the reference: MLUPS + effective memory
    # traffic).  The result carries the executed-step count (resumes don't
    # re-run the checkpointed prefix).
    from lbm_tpu.utils.profiling import PerfReport

    steps = (
        res.steps_timed if res.steps_timed is not None
        else res.params.max_iters
    )
    report = PerfReport(
        nx=res.params.nx,
        ny=res.params.ny,
        steps=steps,
        elapsed=res.elapsed,
    )
    print(f"MLUPS:\t\t\t\t{report.mlups:.1f}")
    print(f"Effective bandwidth:\t\t{report.effective_bandwidth_gbs:.1f} GB/s")


def _run_and_write(args, sim) -> int:
    """Shared driver tail for the single-chip and sharded run paths:
    execute (checkpointed or plain, optionally traced), print the
    epilogue, write the output files."""

    def go():
        if args.checkpoint_dir:
            # Checkpointing needs the full f state on host each segment.
            return sim.run_checkpointed(
                args.checkpoint_dir, every=args.checkpoint_every
            )
        # The run's outputs (final_state.dat + epilogue) only need the 4
        # derived planes; fetch those instead of the 9 f-planes.
        return sim.run(readback="fields")

    if args.profile:
        import jax

        with jax.profiler.trace(args.profile):
            res = go()
    else:
        res = go()
    _epilogue(res)
    outdir = pathlib.Path(args.output_dir)
    outdir.mkdir(parents=True, exist_ok=True)
    write_final_state(
        outdir / "final_state.dat",
        res.params,
        res.f,
        res.obstacles,
        fields=res.fields,
    )
    write_av_vels(outdir / "av_vels.dat", res.av_vels)
    return 0


def _parse_pair(value: str, flag: str) -> tuple[int, int]:
    """Parse an ``AxB`` flag value into two positive ints."""
    try:
        a, b = (int(v) for v in value.lower().split("x"))
    except ValueError:
        raise SystemExit(f"{flag} must be AxB (e.g. 2x4), got {value!r}")
    if a < 1 or b < 1:
        raise SystemExit(f"{flag} values must be positive, got {value!r}")
    return a, b


def cmd_run(args: argparse.Namespace) -> int:
    params, obstacles = _load_case(args.paramfile, args.obstaclefile)
    if args.max_iters is not None:
        import dataclasses

        params = dataclasses.replace(params, max_iters=args.max_iters)
    if args.mesh is not None and args.shards != 1:
        raise SystemExit("give either --shards N (1-D mesh) or --mesh "
                         "PYxPX (2-D mesh), not both")
    if args.shards is not None and args.shards < 1:
        raise SystemExit(f"--shards must be positive, got {args.shards}")
    sharded = args.mesh is not None or (args.shards and args.shards > 1)
    if sharded:
        # Flags the sharded path doesn't implement must fail loudly rather
        # than be silently ignored.
        if args.device is not None:
            raise SystemExit("--device cannot be combined with "
                             "--shards/--mesh (the mesh spans devices)")
        if args.kernel not in ("auto", "reference"):
            raise SystemExit(f"--kernel {args.kernel} is single-device "
                             "only; the sharded paths run the jnp step")
        return _run_sharded(args, params, obstacles)
    device = select_device(args.device)
    # Device inventory + selection line, like the reference's startup
    # stdout (``d2q9-bgk.c:911-918``, 941).
    import jax

    devices = jax.devices()
    print("Available devices:")
    for i, d in enumerate(devices):
        print(f"  {i}: {d.device_kind} ({d.platform})")
    print(f"Selected device {devices.index(device)}: {device.device_kind}")
    sim = Simulator(
        params,
        obstacles,
        kernel=args.kernel,
        device=device,
    )
    # AOT-compile the variant that will actually run, outside the timed
    # region (like clBuildProgram).  Checkpointed runs precompile their
    # own segment-length programs inside run_checkpointed.
    if not args.checkpoint_dir:
        sim.compiled(readback="fields")
    return _run_and_write(args, sim)


def _run_sharded(args, params, obstacles) -> int:
    """Multi-device run over a 1-D (``--shards N``) or 2-D
    (``--mesh PYxPX``) device mesh — the production surface for every
    decomposition ``ShardedSimulator`` supports (the BASELINE.json
    weak-scaling configuration is drivable from this one command, like
    the reference's one-binary contract, ``d2q9-bgk.c:876-880`` +
    ``job_submit_d2q9-bgk:48-52``)."""
    from lbm_tpu.parallel.sharded import (
        ShardedSimulator,
        default_mesh,
        default_mesh_2d,
    )

    if args.mesh is not None:
        py, px = _parse_pair(args.mesh, "--mesh")
        mesh = default_mesh_2d(py, px)
        print(f"Mesh: {py}x{px} (rows x cols) over {py * px} device(s)")
    else:
        mesh = default_mesh(args.shards)
        print(f"Mesh: {args.shards} device(s), row-sharded")
    sim = ShardedSimulator(params, obstacles, mesh=mesh)
    if not args.checkpoint_dir:
        sim.compiled()
    return _run_and_write(args, sim)


def cmd_bench(args: argparse.Namespace) -> int:
    if args.repeats < 1:
        raise SystemExit(f"--repeats must be >= 1, got {args.repeats}")
    params, obstacles = _load_case(args.paramfile, args.obstaclefile)
    import dataclasses

    if args.max_iters is not None:
        params = dataclasses.replace(params, max_iters=args.max_iters)
    sim = Simulator(params, obstacles, kernel=args.kernel)
    sim.compiled(readback="fields")
    best = None
    for _ in range(args.repeats):
        res = sim.run(readback="fields")
        best = res if best is None or res.elapsed < best.elapsed else best
    print(
        json.dumps(
            {
                "metric": f"MLUPS {params.nx}x{params.ny}",
                "value": round(best.mlups, 1),
                "unit": "MLUPS",
                "elapsed_s": round(best.elapsed, 4),
                "reynolds": best.reynolds,
            }
        )
    )
    return 0


def cmd_check(args: argparse.Namespace) -> int:
    from lbm_tpu.checker import compare_files

    ok = compare_files(
        ref_av_vels=args.ref_av_vels_file,
        ref_final_state=args.ref_final_state_file,
        av_vels=args.av_vels_file,
        final_state=args.final_state_file,
        tolerance=args.tolerance,
    )
    return 0 if ok else 1


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="lbm", description="D2Q9-BGK lattice-Boltzmann solver"
    )
    sub = parser.add_subparsers(dest="command", required=True)

    run = sub.add_parser("run", help="simulate and write output files")
    run.add_argument("paramfile")
    run.add_argument("obstaclefile")
    run.add_argument("--output-dir", default=".")
    run.add_argument("--kernel", default="auto", choices=KERNELS,
                     help="step implementation; auto = the Triton kernel "
                     "on a GPU, the jnp step elsewhere")
    run.add_argument("--device", default=None, help="device index (LBM_DEVICE analog)")
    run.add_argument("--max-iters", type=int, default=None)
    run.add_argument("--profile", default=None, metavar="TRACE_DIR",
                     help="write a jax.profiler trace")
    run.add_argument("--checkpoint-dir", default=None,
                     help="snapshot resumable state here (and resume from it)")
    run.add_argument("--checkpoint-every", type=int, default=10000,
                     metavar="STEPS")
    run.add_argument("--shards", type=int, default=1,
                     help="row-shard over N devices (1-D mesh)")
    run.add_argument("--mesh", default=None, metavar="PYxPX",
                     help="2-D spatial decomposition over a PYxPX device "
                     "mesh (rows x cols); exclusive with --shards")
    run.set_defaults(func=cmd_run)

    bench = sub.add_parser("bench", help="timed run, JSON metric output")
    bench.add_argument("paramfile")
    bench.add_argument("obstaclefile")
    bench.add_argument("--kernel", default="auto", choices=KERNELS)
    bench.add_argument("--max-iters", type=int, default=None)
    bench.add_argument("--repeats", type=int, default=4)
    bench.set_defaults(func=cmd_bench)

    check = sub.add_parser("check", help="compare outputs against references")
    check.add_argument("--tolerance", type=float, default=1.0)
    check.add_argument("--ref-av-vels-file", required=True)
    # final_state comparison is optional: the reference stripped the big
    # final_state goldens (check/.MISSING_LARGE_BLOBS), av_vels-only there.
    check.add_argument("--ref-final-state-file", default=None)
    check.add_argument("--av-vels-file", required=True)
    check.add_argument("--final-state-file", default=None)
    check.set_defaults(func=cmd_check)
    return parser


_COMMANDS = ("run", "bench", "check")


def main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    # Reference invocation contract: ``d2q9-bgk <paramfile> <obstaclefile>``
    # (``d2q9-bgk.c:876-880``) — a bare invocation defaults to ``run``.
    if argv and argv[0] not in _COMMANDS and not argv[0].startswith("-"):
        argv = ["run", *argv]
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
