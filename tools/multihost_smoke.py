#!/usr/bin/env python3
"""Multi-host (multi-process) mesh validation on CPU (SURVEY §5.8).

Validates the two multi-host claims the repo makes, on a REAL 2-process
``jax.distributed`` mesh (CPU devices — the same SPMD machinery a
multi-host GPU cluster uses over its network, minus the wire):

1. the sharded SPMD program (shard_map + ppermute + psum) runs unchanged
   across processes and reproduces the single-process reference
   trajectory (f BITWISE; av within psum-regrouping noise);
2. v2 checkpointing writes PER-PROCESS shard files (each process emits
   only its addressable shards — ``lbm_tpu/checkpoint.py:save_sharded``),
   process 0 commits a meta covering every process's files after a
   cross-process barrier, and a resumed run continues bit-identically.

A multi-process run never gathers the global f to one host (jax refuses
to fetch an array spanning non-addressable devices, and that is the
point of per-shard checkpointing) — all global-state comparisons go
through the checkpoint files on the shared filesystem.

Modes:

* coordinator (default): runs a single-process reference trajectory in a
  subprocess, then spawns ``--procs`` worker subprocesses, waits, checks
  exit codes, prints PASS/FAIL.  Exit 0 only when every worker passed.
* ``--single``: compute the single-process reference, write ref.npz.
* worker (``--rank R``): initializes ``jax.distributed``, runs the
  checks.

Usage: python tools/multihost_smoke.py [--procs 2] [--local-devices 2]

The gated slow test ``tests/test_checkpoint.py::test_multihost_smoke``
runs this end-to-end.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import subprocess
import sys
import tempfile

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

STEPS = 40
EVERY = 20


def _case():
    from lbm_tpu.config import LBMParams
    from lbm_tpu.geometry import channel_box

    params = LBMParams(128, 64, STEPS, 10, 0.1, 0.005, 1.85)
    return params, channel_box(params.nx, params.ny, interior_row=29)


def single(workdir: str) -> int:
    """Single-process reference trajectory (jnp kernel — bitwise-equal to
    the sharded jnp path per tests/test_sharded.py)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from lbm_tpu.runtime import Simulator

    params, obstacles = _case()
    res = Simulator(params, obstacles, kernel="reference").run()
    np.savez(
        pathlib.Path(workdir) / "ref.npz", f=res.f, av_vels=res.av_vels
    )
    return 0


def worker(
    rank: int,
    procs: int,
    local_devices: int,
    workdir: str,
    port: int,
    mesh_shape: tuple[int, int] | None,
) -> int:
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={local_devices}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=procs,
        process_id=rank,
    )
    assert jax.process_count() == procs
    n_global = len(jax.devices())
    assert n_global == procs * local_devices
    assert len(jax.local_devices()) == local_devices

    import json

    import numpy as np

    from lbm_tpu import checkpoint as ckpt
    from lbm_tpu.parallel.sharded import (
        ShardedSimulator,
        default_mesh,
        default_mesh_2d,
    )

    params, obstacles = _case()
    if mesh_shape is None:
        py, px = n_global, 1
        mesh = default_mesh(n_global)  # spans ALL processes
    else:
        py, px = mesh_shape
        assert py * px == n_global, (mesh_shape, n_global)
        mesh = default_mesh_2d(py, px)  # 2-D, spans ALL processes

    workdir = pathlib.Path(workdir)
    ckdir = workdir / "ck"

    # --- claim 2: per-process shard writes + cross-process commit ------
    sim = ShardedSimulator(params, obstacles, mesh=mesh)
    res = sim.run_checkpointed(str(ckdir), every=EVERY)
    assert res.steps_timed == params.max_iters
    snap = ckpt.load(ckdir)
    assert snap is not None and snap.step == params.max_iters
    # The committed meta must cover every process's shards (n_global
    # slabs) even though THIS process only wrote its local ones — and
    # each entry's (y0, x0) offset must sit exactly on the mesh's slab
    # lattice (the _shard_filename offset math under multi-process 2-D
    # sharding: py rows x px columns of (nyl, nxl) slabs).
    meta_json = json.loads((ckdir / ckpt.META_FILENAME).read_text())
    assert len(meta_json["shards"]) == n_global, meta_json["shards"]
    nyl, nxl = params.ny // py, params.nx // px
    expected_offsets = {
        (i * nyl, j * nxl) for i in range(py) for j in range(px)
    }
    got_offsets = {(e["y0"], e["x0"]) for e in meta_json["shards"]}
    assert got_offsets == expected_offsets, (got_offsets, expected_offsets)
    for e in meta_json["shards"]:
        assert e["file"] == (
            f"lbm_checkpoint.step{STEPS}.shard.y{e['y0']}.x{e['x0']}.npz"
        )
        assert e["shape"] == [9, nyl, nxl], e
        with np.load(ckdir / e["file"]) as shard:
            assert shard["f_local"].shape == (9, nyl, nxl)

    # --- claim 1: matches the single-process reference trajectory ------
    with np.load(workdir / "ref.npz") as ref:
        np.testing.assert_array_equal(snap.f, ref["f"])
        # av psum regroups per-shard partials (fp32 reassociation).
        np.testing.assert_allclose(
            res.av_vels, ref["av_vels"], rtol=1e-5
        )

        # --- resume bit-continuity --------------------------------------
        # Fresh dir: stop at the mid-run snapshot, resume to completion —
        # the spliced trajectory must equal the uninterrupted one bitwise.
        # The resume runs on a DIFFERENT mesh shape (1-D <-> 2-D swap):
        # shard files are mesh-agnostic f-slabs, so a multi-process resume
        # must re-shard them onto whatever mesh the resuming job brings.
        ckdir2 = workdir / "ck2"
        half = ShardedSimulator(params, obstacles, mesh=mesh)
        half.run_checkpointed(str(ckdir2), every=EVERY, max_iters=EVERY)
        assert ckpt.load(ckdir2).step == EVERY
        if px > 1:
            resume_mesh = default_mesh(n_global)
        elif params.ny % (n_global // 2) == 0:
            resume_mesh = default_mesh_2d(n_global // 2, 2)
        else:
            resume_mesh = mesh
        resumed = ShardedSimulator(params, obstacles, mesh=resume_mesh)
        res2 = resumed.run_checkpointed(str(ckdir2), every=EVERY)
        assert res2.steps_timed == STEPS - EVERY  # only the second half ran
        np.testing.assert_array_equal(ckpt.load(ckdir2).f, ref["f"])
        np.testing.assert_allclose(res2.av_vels, ref["av_vels"], rtol=1e-5)
    np.testing.assert_array_equal(ckpt.load(ckdir2).f, snap.f)

    print(f"rank {rank}: PASS", flush=True)
    return 0


def coordinator(
    procs: int, local_devices: int, mesh: str | None
) -> int:
    with tempfile.TemporaryDirectory(prefix="lbm_mh_") as workdir:
        env = dict(os.environ)
        # CPU-only subprocesses: several processes must never contend for
        # one accelerator.
        env["JAX_PLATFORMS"] = "cpu"
        env.setdefault("LBM_COMPILE_CACHE", "off")
        script = str(REPO / "tools" / "multihost_smoke.py")
        ref = subprocess.run(
            [sys.executable, script, "--single", "--workdir", workdir],
            env=env,
            timeout=600,
        )
        if ref.returncode:
            print("FAIL: single-process reference run failed", flush=True)
            return 1
        # Ephemeral coordinator port: a fixed one collides when two
        # invocations share the box (a slow-tier pytest plus a manual
        # run) — the second rank 0 fails to bind or workers join the
        # wrong coordinator and hang to the wait timeout.  SO_REUSEADDR
        # + holding the probe socket until just before the spawn shrinks
        # (but cannot close — standard ephemeral-port pattern) the TOCTOU
        # window in which another process could grab the port between
        # our close and rank 0's coordinator bind.
        import socket

        sock = socket.socket()
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
        mesh_args = ["--mesh", mesh] if mesh else []
        sock.close()
        workers = [
            subprocess.Popen(
                [
                    sys.executable,
                    script,
                    "--rank",
                    str(rank),
                    "--procs",
                    str(procs),
                    "--local-devices",
                    str(local_devices),
                    "--workdir",
                    workdir,
                    "--port",
                    str(port),
                    *mesh_args,
                ],
                env=env,
            )
            for rank in range(procs)
        ]
        try:
            codes = [w.wait(timeout=900) for w in workers]
        finally:
            # A timeout on one wait must not leak the rest: kill any
            # still-running worker before the TemporaryDirectory (their
            # cwd for checkpoints) is torn down.
            for w in workers:
                if w.poll() is None:
                    w.kill()
                    w.wait()
    if any(codes):
        print(f"FAIL: worker exit codes {codes}", flush=True)
        return 1
    topo = f"mesh {mesh}" if mesh else "1-D mesh"
    print(
        f"PASS: {procs} processes x {local_devices} devices ({topo})",
        flush=True,
    )
    return 0


def _parse_mesh(mesh: str | None) -> tuple[int, int] | None:
    if mesh is None:
        return None
    try:
        py, px = (int(p) for p in mesh.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh must be PYxPX (e.g. 2x4), got {mesh!r}")
    return py, px


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--procs", type=int, default=2)
    parser.add_argument("--local-devices", type=int, default=2)
    parser.add_argument(
        "--mesh",
        default=None,
        help="2-D device mesh PYxPX spanning all processes "
        "(default: 1-D over all devices); py*px must equal "
        "procs*local_devices",
    )
    parser.add_argument("--rank", type=int, default=None)
    parser.add_argument("--single", action="store_true")
    parser.add_argument("--workdir", default=None)
    parser.add_argument("--port", type=int, default=None)
    args = parser.parse_args(argv)
    if args.single:
        return single(args.workdir)
    if args.rank is not None:
        if args.port is None:
            parser.error(
                "--port is required with --rank (workers must join the "
                "coordinator's ephemeral port; without it the address "
                "would be the nonsensical '127.0.0.1:None')"
            )
        return worker(
            args.rank,
            args.procs,
            args.local_devices,
            args.workdir,
            args.port,
            _parse_mesh(args.mesh),
        )
    return coordinator(args.procs, args.local_devices, args.mesh)


if __name__ == "__main__":
    sys.exit(main())
