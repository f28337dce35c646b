#!/usr/bin/env python3
"""Compare the Triton step kernel with XLA's jnp step on one GPU.

Runs in one process on the first GPU and fails when JAX finds none:

* timing — ``Simulator.run`` end to end (fields readback, as the CLI runs)
  at 128², 1024² and 8192² for the jnp step and the Triton kernel at each
  ``--tiles`` tile, in turns (jnp, variants, variants reversed, jnp), best
  and all times printed;
* correctness — the Triton step against the jnp step at 1024² and 8192²:
  max |Δf| relative to max |f| after 1 and 1,000 steps, av_vels relative
  difference and distance from the fp64 golden after 1,000 steps, and the
  av of one step from the same f against the fp64 engine;
* memory — ``peak_bytes_in_use`` of the 8192² state-readback program (run
  first, so the process peak is its own) and ``memory_analysis()`` of
  each compiled program;
* trace — ``jax.profiler`` traces of 100 steps at 1024² on each side,
  reduced to device events per step and time per kernel name.

Usage: ``python tools/compare_step.py [--out DIR] [--tiles 4x256,2x512]``.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import pathlib
import sys
import time
from collections import defaultdict

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import numpy as np  # noqa: E402

import lbm_tpu  # noqa: E402
from lbm_tpu.ops import triton_step  # noqa: E402
from lbm_tpu.utils.profiling import device_report  # noqa: E402

_ORIG_MAKE = triton_step.make_triton_program


def case(name: str):
    if name in lbm_tpu.CANONICAL_PARAMS:
        return lbm_tpu.CANONICAL_PARAMS[name], lbm_tpu.canonical_obstacles(name)
    n = int(name.split("x")[0])
    p = dataclasses.replace(lbm_tpu.CANONICAL_PARAMS["1024x1024"], nx=n, ny=n)
    return p, lbm_tpu.channel_box(n, n)


def sim_for(variant: str, params, obs) -> lbm_tpu.Simulator:
    """``variant``: "jnp", or "triton_TYxTX" for the kernel at that tile."""
    if variant == "jnp":
        return lbm_tpu.Simulator(params, obs, kernel="reference")
    tile = tuple(map(int, variant.split("_")[1].split("x")))
    # The tile holds until compile_variant has traced the program.
    triton_step.make_triton_program = (
        lambda *a, **k: _ORIG_MAKE(*a, tile=tile, **k)
    )
    return lbm_tpu.Simulator(params, obs, kernel="triton")


def compile_variant(variant, params, obs, steps, readback):
    sim = sim_for(variant, params, obs)
    t0 = time.perf_counter()
    exe = sim.compiled(steps, readback=readback)
    compile_s = time.perf_counter() - t0
    triton_step.make_triton_program = _ORIG_MAKE
    return sim, exe, compile_s


def memory_line(exe) -> str:
    ma = exe.executable.memory_analysis()
    return (f"temp={ma.temp_size_in_bytes} arg={ma.argument_size_in_bytes} "
            f"out={ma.output_size_in_bytes} alias={ma.alias_size_in_bytes}")


def reduce_trace(trace_dir: str, steps: int) -> dict:
    from jax.profiler import ProfileData

    paths = glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True)
    pd = ProfileData.from_file(sorted(paths)[-1])
    per_line: dict = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            tot = defaultdict(lambda: [0, 0.0])
            for ev in line.events:
                tot[ev.name][0] += 1
                tot[ev.name][1] += ev.duration_ns
            if tot:
                top = sorted(tot.items(), key=lambda kv: -kv[1][1])[:8]
                per_line[f"{plane.name}|{line.name}"] = {
                    "events_per_step": sum(c for c, _ in tot.values()) / steps,
                    "top": [(n[:60], c, round(d / 1e3 / steps, 2))
                            for n, (c, d) in top],
                }
    return per_line


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/compare_step")
    ap.add_argument("--tiles", default="x".join(
        map(str, triton_step.DEFAULT_TILE)),
        help="comma-separated TYxTX Triton tiles to time")
    args = ap.parse_args()
    order = ["jnp"] + [f"triton_{t}" for t in args.tiles.split(",")]
    checked = order[:2]
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX found {dev.platform}", file=sys.stderr)
        return 1
    report = device_report()
    print("device:", json.dumps(report))
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    results: dict = {"device": report}

    # 1. Memory: the 8192^2 state-readback program first in the process.
    p8, o8 = case("8192x8192")
    sim, exe, cs = compile_variant("jnp", p8, o8, 10, "state")
    sim.run(10, readback="state")
    peak = dev.memory_stats()["peak_bytes_in_use"]
    fbytes = 9 * p8.ny * p8.nx * 4
    print(f"8192^2 jnp state readback: peak_bytes_in_use={peak} "
          f"= {peak / fbytes:.3f} x f ({fbytes} B); {memory_line(exe)}")
    results["state_peak"] = {"peak": peak, "f_bytes": fbytes,
                             "factor": peak / fbytes}
    del sim, exe

    # 2. Correctness at 1024^2 and 8192^2: each variant against the jnp
    # step after 1 and 1,000 steps, and against the fp64 goldens where
    # they exist.  Then the reduction alone: one step from the SAME f
    # (the jnp state after 999 steps), each path's av against the fp64
    # engine's av of that step.
    from lbm_tpu.validation import run64

    goldens = pathlib.Path(__file__).resolve().parent.parent / "tests/goldens"
    gold = {"1024x1024": np.loadtxt(
        goldens / "1024x1024.fp64gen_av_vels.dat", usecols=[1])[:1000]}
    for name in ("1024x1024", "8192x8192"):
        p, o = case(name)
        f1, fk, av = {}, {}, {}
        for v in checked:
            sim, _, _ = compile_variant(v, p, o, 1, "state")
            f1[v] = sim.run(1, readback="state").f
            sim, _, _ = compile_variant(v, p, o, 1000, "state")
            r = sim.run(1000, readback="state")
            fk[v], av[v] = r.f, r.av_vels
            del sim, r
        sim, _, _ = compile_variant("jnp", p, o, 999, "state")
        f999 = sim.run(999, readback="state").f
        del sim
        av64 = float(run64(p, o, 1, f0=f999)[1][0])
        one = {}
        for v in checked:
            sim, _, _ = compile_variant(v, p, o, 1, "state")
            one[v] = float(sim.run(1, f0=f999, readback="state").av_vels[0])
            del sim
        for v in checked:
            d1 = float(np.abs(f1[v] - f1["jnp"]).max() / np.abs(f1["jnp"]).max())
            dk = float(np.abs(fk[v] - fk["jnp"]).max() / np.abs(fk["jnp"]).max())
            dav = float(np.abs((av[v] - av["jnp"]) / av["jnp"]).max())
            g = (float(np.abs((av[v] - gold[name]) / gold[name]).max())
                 if name in gold else float("nan"))
            r64 = abs(one[v] - av64) / av64
            print(f"{name} {v}: f rel 1-step={d1:.3e} 1000-step={dk:.3e}; "
                  f"av rel vs jnp={dav:.3e} vs fp64 golden={g:.3e}; "
                  f"step-1000 av from one f vs fp64: {r64:.3e}")
            results[f"check_{name}_{v}"] = dict(
                df1=d1, df1000=dk, av_vs_jnp=dav, av_vs_golden=g,
                reduction_vs_fp64=r64)
        del f1, fk, av, f999
    # 3. Timing, in turns.
    sizes = {"128x128": 20000, "1024x1024": 4000, "8192x8192": 200}
    for name, steps in sizes.items():
        p, o = case(name)
        sims = {}
        for v in order:
            sim, exe, cs = compile_variant(v, p, o, steps, "fields")
            sims[v] = sim
            print(f"{name} {v}: compile {cs:.2f} s; {memory_line(exe)}")
            sim.run(steps, readback="fields")  # warm
        times = defaultdict(list)
        for rnd in (order, order[::-1], order, order[::-1]):
            for v in rnd:
                times[v].append(sims[v].run(steps, readback="fields").elapsed)
        for v in order:
            best = min(times[v])
            print(f"{name} {v}: best {best * 1e6 / steps:.3f} us/step = "
                  f"{p.nx * p.ny * steps / best / 1e6:.1f} MLUPS; all "
                  + " ".join(f"{t:.5f}" for t in times[v]))
            results[f"time_{name}_{v}"] = times[v]
        del sims

    # 4. Traces at 1024^2, 100 steps.
    p, o = case("1024x1024")
    for v in checked:
        sim, _, _ = compile_variant(v, p, o, 100, "fields")
        sim.run(100, readback="fields")
        tdir = str(out / f"trace_{v}")
        with jax.profiler.trace(tdir):
            sim.run(100, readback="fields")
        red = reduce_trace(tdir, 100)
        results[f"trace_{v}"] = red
        for line, d in red.items():
            print(f"trace {v} {line}: {d['events_per_step']:.2f} ev/step")
            for n, c, us in d["top"]:
                print(f"    {us:9.2f} us/step  x{c}  {n}")
    (out / "results.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
