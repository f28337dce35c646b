#!/usr/bin/env python3
"""Weak-scaling benchmark: the BASELINE.json configs[4] case — a grid
sharded over a device mesh with per-step halo exchange.

Builds the case, runs the sharded jnp path on a 1-D row mesh or a 2-D
rows x cols mesh, and reports total + per-device MLUPS and the halo
traffic per step.  Timing excludes the device->host readback (the
weak-scaling metric is the sustained on-device step rate).  The JSON line
names the devices it ran on.

    python tools/bench_sharded.py                      # 4096^2, all devices
    python tools/bench_sharded.py --shards 4 --ny 8192 --nx 8192
    python tools/bench_sharded.py --mesh 2x2

CPU smoke (the 8-virtual-device mesh used by the test suite):

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tools/bench_sharded.py --ny 256 --nx 256 --max-iters 50
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--shards", type=int, default=None,
                        help="1-D mesh size (default: all devices)")
    parser.add_argument("--mesh", default=None, metavar="PYxPX",
                        help="2-D mesh shape, e.g. 4x2 (overrides --shards)")
    parser.add_argument("--ny", type=int, default=4096)
    parser.add_argument("--nx", type=int, default=4096)
    parser.add_argument("--max-iters", type=int, default=2000)
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args(argv)

    import jax

    from lbm_tpu.config import LBMParams
    from lbm_tpu.geometry import channel_box
    from lbm_tpu.ops.reference import init_cells
    from lbm_tpu.utils.profiling import device_report
    from lbm_tpu.parallel.sharded import (
        AXIS,
        AXIS_X,
        ShardedSimulator,
        default_mesh,
        default_mesh_2d,
    )
    from jax.sharding import NamedSharding, PartitionSpec as P

    # Same physics as the canonical cases; a closed channel box (the
    # 1024x1024 case's geometry family) scaled to the weak-scaling grid.
    params = LBMParams(args.nx, args.ny, args.max_iters, 10, 0.1, 0.005, 1.85)
    obstacles = channel_box(args.nx, args.ny)
    if args.mesh:
        py, px = (int(v) for v in args.mesh.lower().split("x"))
        mesh = default_mesh_2d(py, px)
        n = py * px
        in_spec = P(None, AXIS, AXIS_X)
        mesh_desc = f"{py}x{px} mesh"
    else:
        n = args.shards if args.shards is not None else len(jax.devices())
        mesh = default_mesh(n)
        in_spec = P(None, AXIS, None)
        mesh_desc = f"{n} shards"
    sim = ShardedSimulator(params, obstacles, mesh=mesh)
    fn = sim.compiled(args.max_iters)

    sharding = NamedSharding(mesh, in_spec)
    f = jax.device_put(init_cells(params), sharding)
    f, av = fn(f)  # warmup pass (donated: f is reusable)
    jax.device_get(av[-1])

    best = float("inf")
    for _ in range(args.repeats):
        tic = time.perf_counter()
        f, av = fn(f)
        jax.device_get(av[-1])  # sync on the scalar stream, not f
        best = min(best, time.perf_counter() - tic)

    cells = params.nx * params.ny
    mlups = cells * args.max_iters / best / 1e6
    # Halo traffic per step per shard (nominal): one 9-speed boundary
    # row/column each way per ring that actually crosses devices.
    # Degenerate rings (py==1 / px==1 / 1 shard) self-wrap locally.
    if args.mesh:
        nyl, nxl = params.ny // py, params.nx // px
        y_bytes = 0 if py == 1 else 2 * 9 * 4 * nxl
        x_bytes = 0 if px == 1 else 2 * 9 * 4 * (nyl + 2)
        halo_bytes_per_step = y_bytes + x_bytes
    else:
        halo_bytes_per_step = 0 if n == 1 else 2 * 9 * params.nx * 4
    print(
        json.dumps(
            {
                "metric": f"weak-scaling {params.ny}x{params.nx} over {mesh_desc}",
                "value": round(mlups / n, 1),
                "unit": "MLUPS/device",
                "total_mlups": round(mlups, 1),
                "us_per_step": round(best / args.max_iters * 1e6, 2),
                "halo_bytes_per_step_per_shard": halo_bytes_per_step,
                "shards": n,
                "max_iters": args.max_iters,
                "device": device_report(),
                "av_last": float(np.asarray(jax.device_get(av[-1]))),
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
