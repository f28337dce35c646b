"""Host runtime: device selection, compilation cache, and the scan driver.

This is the analog of the reference's host layer (C1 + C4):

* Device discovery/selection — env var ``LBM_DEVICE`` indexes
  ``jax.devices()``, mirroring ``OCL_DEVICE`` (``d2q9-bgk.c:885-944``).
* Per-grid kernel specialization — ``jax.jit`` retraces per (grid shape,
  params), the analog of rebuilding ``kernels.cl`` with ``-D`` constants
  (``d2q9-bgk.c:639-663``).
* The time loop — the reference enqueues ``maxIters`` asynchronous kernel
  launches and syncs once at the end (``d2q9-bgk.c:221-240``).  Here the
  *entire* loop is one compiled XLA program: ``lax.scan`` carries
  ``f[9, ny, nx]`` on the device, accumulates the per-step average
  velocity into a device array, and the host touches data exactly twice (upload f0,
  download f_final + av_vels) — the same two-transfer contract.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from lbm_tpu import diagnostics
from lbm_tpu.config import LBMParams
from lbm_tpu.geometry import free_cells_of
from lbm_tpu.ops.program import StepProgram, make_reference_program
from lbm_tpu.ops.reference import init_cells

StepFn = Callable[[jax.Array], tuple[jax.Array, jax.Array]]

# "state"  — fetch the 9 f-planes to host.
# "fields" — fetch the compact float16 [u_x, u_y, rho - density]
#            payload, reconstruct on host.
# "device" — return f as the (possibly sharded) on-device array, no fetch
#            (the checkpointed segment driver's mode: f never round-trips
#            the host link between segments; av_vels is still fetched, and
#            that fetch is the sync point the elapsed timer stops on).
READBACK_MODES = ("state", "fields", "device")

# The state-readback program peaks at about this multiple of f's bytes:
# the carried f, the step's output f and the step's temporaries coexist.
# Measured: 2.806x at 8192^2 with the jnp step (peak_bytes_in_use
# 6,777,996,800 B for a 2,415,919,104 B f) on an NVIDIA H100 80GB HBM3
# at a 700 W power limit; the Triton kernel's programs need less.
_STATE_READBACK_PEAK_FACTOR = 2.81


def hbm_budget_gib(device: jax.Device | None = None) -> float | None:
    """Device-memory budget for the state-readback predicate, in GiB:
    the ``LBM_HBM_GIB`` override, else the device's reported
    ``memory_stats()['bytes_limit']``, else None (no budget known — the
    predicate then does not apply)."""
    env = os.environ.get("LBM_HBM_GIB")
    if env:
        return float(env)
    stats = device.memory_stats() if device is not None else None
    limit = (stats or {}).get("bytes_limit")
    return limit / 2**30 if limit else None


def state_readback_fits(
    ny: int, nx: int, budget_gib: float | None = None
) -> bool:
    """Whether the full-state readback program's peak device footprint is
    expected to fit in ``budget_gib`` (default: the ``LBM_HBM_GIB``
    override).  With no budget known it is assumed to fit."""
    if budget_gib is None:
        budget_gib = hbm_budget_gib()
    if budget_gib is None:
        return True
    f_gib = 9 * ny * nx * 4 / 2**30
    return _STATE_READBACK_PEAK_FACTOR * f_gib <= budget_gib


def raw_fields_fn(params: LBMParams, obstacles: np.ndarray):
    """Device-side ``f -> [u_x, u_y, rho - density]`` in float16 — the
    COMPACT fields-readback payload.

    The device->host fetch is inside the timed region (the reference
    reads the full 9-plane fp32 cells buffer inside ITS timer,
    ``d2q9-bgk.c:252-261``), so the payload is compressed two ways:

    * |u| and pressure are derived on host (:func:`expand_fields`) — 3
      planes instead of 4;
    * the 3 planes travel as float16, halving the bytes again.  Precision:
      the checker protocol validates only the PRESSURE column of
      final_state (``check/check.py:66`` loads usecols [0, 1, 5]), and
      pressure = rho/3 with rho DELTA-encoded against the nominal density
      — the fp16 quantum of the small fluctuation field (|rho - density|
      ~1e-2) bounds the absolute rho error at ~3e-5 (~0.003% on pressure,
      ~300x inside the 1% tolerance, vs the fp32 engine's own ~0.2%
      drift).  u_x/u_y (written to final_state.dat but outside the checked
      protocol; visualization payload) carry <=0.1% relative error — far
      below plottable differences.  av_vels stays fp32 end-to-end.

    u is masked to 0 on obstacle cells on device (``d2q9-bgk.c:789-836``
    semantics).

    The returned function takes an optional ``fluid`` operand (bool
    [ny, nx]).  Jitted callers pass it as a runtime argument: the
    embedded-closure default lowers the mask to an HLO ``dense<"0x...">``
    literal (~2 hex chars/element), so the compiled module and its cache
    key would grow with the grid (the rule ``StepProgram.consts``
    follows).  The default exists for eager/small ad-hoc use only."""
    density = float(np.float32(params.density))
    fluid_host = ~np.asarray(obstacles, dtype=bool)

    def fields(f, fluid=None):
        if fluid is None:
            fluid = jnp.asarray(fluid_host)
        rho = jnp.sum(f, axis=0)
        ux = jnp.where(fluid, (f[1] + f[5] + f[8] - f[3] - f[6] - f[7]) / rho, 0.0)
        uy = jnp.where(fluid, (f[2] + f[5] + f[6] - f[4] - f[7] - f[8]) / rho, 0.0)
        return jnp.stack([ux, uy, rho - density]).astype(jnp.float16)

    return fields


def expand_fields(
    raw: np.ndarray, obstacles: np.ndarray, density: float
) -> np.ndarray:
    """Host-side ``[u_x, u_y, rho - density] -> [u_x, u_y, |u|, pressure]``
    (the complete ``final_state.dat`` payload; obstacle cells get u = 0
    and pressure = density/3 per ``d2q9-bgk.c:789-836``).  Reconstruction
    runs in fp64 and rounds to fp32; see :func:`raw_fields_fn` for the
    float16 payload encoding and its error bounds."""
    fluid = ~np.asarray(obstacles, dtype=bool)
    ux = np.asarray(raw[0], dtype=np.float64)
    uy = np.asarray(raw[1], dtype=np.float64)
    rho = float(np.float32(density)) + np.asarray(raw[2], dtype=np.float64)
    speed = np.sqrt(ux * ux + uy * uy)
    pressure = np.where(fluid, rho / 3.0, density / 3.0)
    return np.stack([ux, uy, speed, pressure]).astype(np.float32)


def check_readback(readback: str) -> None:
    if readback not in READBACK_MODES:
        raise ValueError(
            f"readback must be one of {READBACK_MODES}, got {readback!r}"
        )


_COMPILE_CACHE_STATE: list[str | None] = []  # [dir-or-None] once set

# The default persistent-cache directory: fixed inside the checkout, so
# every process run from it (CLI, library, benchmark) finds what the
# others compiled.  Listed in .gitignore.
DEFAULT_COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compile_cache() -> str | None:
    """Point XLA's persistent compilation cache at a directory
    (idempotent; returns the directory, or None when disabled).

    The reference JIT-builds ``kernels.cl`` on EVERY invocation
    (``clBuildProgram``, ``d2q9-bgk.c:639-663``); XLA's disk cache lets a
    later process reuse a full-run executable instead.  Keyed by the
    computation fingerprint + jaxlib/platform, so it is always safe to
    leave on.

    Precedence: a directory already configured in JAX (which is where
    ``JAX_COMPILATION_CACHE_DIR`` lands) wins and nothing else is set;
    then ``LBM_COMPILE_CACHE`` (a directory path, or ``0``/``off`` to
    disable); then :data:`DEFAULT_COMPILE_CACHE_DIR`.  Only entries whose
    compile took >= 1 s are written (tiny test jits don't churn disk).
    """
    if _COMPILE_CACHE_STATE:
        return _COMPILE_CACHE_STATE[0]
    existing = jax.config.jax_compilation_cache_dir
    if existing:
        # The environment or the embedding application already configured
        # XLA's cache — never re-point it out from under them.
        _COMPILE_CACHE_STATE.append(existing)
        return existing
    spec = os.environ.get("LBM_COMPILE_CACHE", "")
    if spec.lower() in ("0", "off", "none", "disable", "disabled"):
        _COMPILE_CACHE_STATE.append(None)
        return None
    path = spec or DEFAULT_COMPILE_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    _COMPILE_CACHE_STATE.append(path)
    return path


def select_device(spec: str | int | None = None) -> jax.Device:
    """Pick the compute device (``LBM_DEVICE`` env analog of OCL_DEVICE)."""
    if spec is None:
        spec = os.environ.get("LBM_DEVICE", "")
    devices = jax.devices()
    if spec == "" or spec is None:
        return devices[0]
    idx = int(spec)
    if not 0 <= idx < len(devices):
        raise ValueError(
            f"LBM_DEVICE={idx} out of range; {len(devices)} device(s): {devices}"
        )
    return devices[idx]


KERNELS = ("auto", "reference", "triton")


def resolve_kernel(kernel: str, platform: str) -> str:
    """``auto`` -> the Triton kernel on a GPU, the jnp step elsewhere."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    if kernel == "auto":
        return "triton" if platform == "gpu" else "reference"
    return kernel


def make_program(
    params: LBMParams,
    obstacles: np.ndarray,
    free_cells_inv: np.float32,
    kernel: str = "reference",
) -> StepProgram:
    """Step-program factory; ``kernel`` is 'reference' (the jnp step) or
    'triton' (the Pallas GPU kernel)."""
    if kernel == "reference":
        return make_reference_program(params, obstacles, free_cells_inv)
    if kernel == "triton":
        from lbm_tpu.ops.triton_step import make_triton_program

        return make_triton_program(params, obstacles, free_cells_inv)
    raise ValueError(f"unknown kernel {kernel!r}")


def make_step(
    params: LBMParams,
    obstacles: np.ndarray,
    free_cells_inv: np.float32,
    kernel: str = "auto",
) -> StepFn:
    """Plain ``f -> (f', av)`` step function (see :func:`make_program`);
    ``kernel="auto"`` resolves for the default backend."""
    kernel = resolve_kernel(kernel, jax.default_backend())
    return make_program(params, obstacles, free_cells_inv, kernel).single()


@dataclasses.dataclass
class RunResult(diagnostics.ResultMetrics):
    """Outcome of a full simulation run.

    Exactly one of ``f`` (readback="state"/"device", the 9 distribution
    planes) or ``fields`` (readback="fields": ``[u_x, u_y, |u|,
    pressure]`` — everything ``final_state.dat`` needs) is set.
    """

    params: LBMParams
    f: np.ndarray | None  # [9, ny, nx] float32 final distributions
    av_vels: np.ndarray  # [maxIters] float32 per-step mean fluid speed
    obstacles: np.ndarray  # [ny, nx] bool
    free_cells_inv: float
    elapsed: float  # seconds, upload -> download (reference's tic..toc)
    fields: np.ndarray | None = None  # [4, ny, nx] float32
    # Timesteps actually executed within ``elapsed`` — differs from
    # params.max_iters when a checkpointed run RESUMED partway (perf
    # figures must not credit the pre-crash steps to this invocation).
    steps_timed: int | None = None


class Simulator:
    """One configured simulation: grid, obstacles, compiled step program."""

    def __init__(
        self,
        params: LBMParams,
        obstacles: np.ndarray,
        *,
        kernel: str = "auto",
        device: jax.Device | None = None,
        collect_av_vels: bool = True,
    ) -> None:
        obstacles = np.asarray(obstacles, dtype=bool)
        if obstacles.shape != (params.ny, params.nx):
            raise ValueError(
                f"obstacle mask {obstacles.shape} != grid {(params.ny, params.nx)}"
            )
        self.params = params
        self.obstacles = obstacles
        self.free_cells = free_cells_of(obstacles)
        self.free_cells_inv = np.float32(1.0) / np.float32(self.free_cells)
        self.device = device if device is not None else select_device()
        enable_compile_cache()
        self.kernel = resolve_kernel(kernel, self.device.platform)
        self._collect = collect_av_vels
        self._compiled: dict[tuple[int, str, bool], Any] = {}
        self._init_compiled: Any = None

    # -- compiled program ---------------------------------------------------

    def _build(self, max_iters: int, readback: str = "state",
               from_f0: bool = True):
        """readback: 'state' returns the 9-plane f, 'fields' the compact
        3-plane payload (see :func:`raw_fields_fn`).  ``from_f0=False``
        builds the zero-f-argument variant: the canonical uniform initial
        state is built INSIDE the compiled program (one fewer executable
        dispatch per run)."""
        program = make_program(
            self.params, self.obstacles, self.free_cells_inv, self.kernel
        )
        n_pconsts = len(program.consts)
        extra_consts: tuple = ()
        if readback == "fields":
            # The fluid mask rides as a runtime operand (appended to the
            # program consts), never as a jit closure constant (the
            # mask-literal rule, see raw_fields_fn).
            finalize = raw_fields_fn(self.params, self.obstacles)
            extra_consts = (np.asarray(~self.obstacles, dtype=bool),)

            def emit(carry, fluid):
                return finalize(program.final(carry), fluid)

        else:

            def emit(carry):
                return program.final(carry)

        def body(carry, _):
            carry, av = program.step(carry)
            return carry, av if self._collect else None

        def scan(f0, consts):
            carry, av = jax.lax.scan(
                body,
                program.init(f0, *consts[:n_pconsts]),
                None,
                length=max_iters,
            )
            return emit(carry, *consts[n_pconsts:]), av

        if from_f0:
            # Donation lets XLA alias f0 with the returned f buffer; in
            # fields mode no output matches the input shape, so donating
            # would only emit a "donated buffers were not usable" warning.
            donate = (0,) if readback == "state" else ()

            @functools.partial(jax.jit, donate_argnums=donate)
            def run_scan(f0, *consts):
                return scan(f0, consts)

        else:
            # No f argument to infer placement from: pin the outputs (and
            # with them the whole program) to the bound device.
            sharding = jax.sharding.SingleDeviceSharding(self.device)

            @functools.partial(jax.jit, out_shardings=sharding)
            def run_scan(*consts):
                return scan(init_cells(self.params), consts)

        run_scan.consts = (*program.consts, *extra_consts)
        return run_scan

    def compiled(self, max_iters: int | None = None, readback: str = "state",
                 from_f0: bool = False):
        """AOT-compile (and cache) the full-run program for ``max_iters``.

        Ahead-of-time compilation is the analog of the reference's
        ``clBuildProgram`` inside ``initialise()`` — it happens before the
        run timer starts.

        ``from_f0=False`` (the plain-``run()`` variant) takes no f
        argument: initialization is fused into the program (see
        ``_build``).  ``from_f0=True`` is the ``f(f0)`` variant used when
        the caller supplies a starting state (checkpoint resume).
        """
        check_readback(readback)
        if max_iters is None:
            max_iters = self.params.max_iters
        # "device" runs the identical program as "state" (the difference is
        # only whether the caller fetches) — share the compile cache entry.
        if readback == "device":
            readback = "state"
        if readback == "state" and not state_readback_fits(
            self.params.ny, self.params.nx, hbm_budget_gib(self.device)
        ):
            import warnings

            warnings.warn(
                f"state readback at {self.params.ny}x{self.params.nx} "
                f"peaks at ~{_STATE_READBACK_PEAK_FACTOR}x f's bytes and "
                "may exceed device memory; use readback='fields' for "
                "giant grids",
                stacklevel=2,
            )
        key = (max_iters, readback, from_f0)
        if key not in self._compiled:
            # Bind the target device at lowering time; otherwise the
            # executable is pinned to the default device and a non-default
            # LBM_DEVICE/--device run fails with a sharding mismatch.
            sharding = jax.sharding.SingleDeviceSharding(self.device)
            fn = self._build(max_iters, readback=readback, from_f0=from_f0)
            consts = fn.consts
            cspecs = [
                jax.ShapeDtypeStruct(
                    np.shape(c), np.asarray(c).dtype, sharding=sharding
                )
                for c in consts
            ]
            spec = jax.ShapeDtypeStruct(
                (9, self.params.ny, self.params.nx),
                jnp.float32,
                sharding=sharding,
            )
            args = (spec, *cspecs) if from_f0 else tuple(cspecs)
            exe = fn.lower(*args).compile()
            # Bind the device-resident consts so callers keep the plain
            # ``fn(f)`` / ``fn()`` calling convention.
            cdev = tuple(
                jax.device_put(np.asarray(c), self.device) for c in consts
            )
            if from_f0:
                def run(f):
                    return exe(f, *cdev)
            else:
                def run():
                    return exe(*cdev)
            run.executable = exe  # for memory_analysis() and cost reports
            self._compiled[key] = run
        # The f0-variant needs the standalone on-device initializer (the
        # checkpoint driver seeds fresh runs from it); pre-build it so the
        # first run() doesn't pay its trace/compile inside the timed
        # region.  The plain variant fuses initialization into the program.
        if from_f0:
            self._init_program()
        return self._compiled[key]

    def _init_program(self):
        """AOT-compiled zero-arg initial-state program: f0 is a constant
        9-plane broadcast (``d2q9-bgk.c:529-550``) generated directly on
        the target device — no host-side array, no upload."""
        if self._init_compiled is None:
            sharding = jax.sharding.SingleDeviceSharding(self.device)
            fn = jax.jit(
                functools.partial(init_cells, self.params),
                out_shardings=sharding,
            )
            self._init_compiled = fn.lower().compile()
        return self._init_compiled

    def initial_state(self) -> jax.Array:
        return self._init_program()()

    def step_fn(self) -> StepFn:
        """The raw (unjitted) single-step function, for composition/tests."""
        return make_program(
            self.params, self.obstacles, self.free_cells_inv, self.kernel
        ).single()

    # -- driver ---------------------------------------------------------------

    def run(
        self,
        max_iters: int | None = None,
        f0: np.ndarray | jax.Array | None = None,
        warmup: bool = False,
        readback: str = "state",
    ) -> RunResult:
        """Initialise, run the time loop on-device, read back once.

        ``readback="fields"`` fetches the compact float16
        ``[u_x, u_y, rho - density]`` payload instead of the 9 fp32
        f-planes — everything the output writers and the epilogue need at
        ~1/6 of the transfer bytes (encoding + error bounds:
        :func:`raw_fields_fn`); |u|/pressure are reconstructed on host
        after the timer stops.

        A device-resident ``f0`` is DONATED to the compiled program (the
        run updates f in place, so the caller's buffer is consumed —
        reusing it afterwards raises "Array has been deleted"; pass
        ``jnp.copy(f0)`` to keep a live copy).  Host-side ``f0`` arrays
        are copied on upload and stay valid.
        """
        if max_iters is None:
            max_iters = self.params.max_iters
        del warmup  # compilation is always ahead-of-time via compiled()
        from_f0 = f0 is not None
        fn = self.compiled(max_iters, readback=readback, from_f0=from_f0)
        tic = time.perf_counter()
        if from_f0:
            if isinstance(f0, jax.Array):
                if f0.dtype != jnp.float32:
                    f0 = f0.astype(jnp.float32)
                f = jax.device_put(f0, self.device)
            else:
                # Direct host->device upload.  jnp.asarray first would
                # materialize the array on the DEFAULT device and pay a
                # second device-to-device copy when a non-default device
                # is bound.
                f = jax.device_put(np.asarray(f0, np.float32), self.device)
            out, av = fn(f)
        else:
            # Initialization is fused into the compiled program — the
            # timed region is a single executable dispatch plus the fetch.
            out, av = fn()
        if readback == "device":
            # f stays on device (the checkpointed segment driver feeds it
            # straight into the next segment); fetch only the av stream —
            # it depends on every step, so its arrival is the sync point.
            out_host = out
            if self._collect:
                av_host = np.asarray(jax.device_get(av))
            else:
                jax.block_until_ready(out)
                av_host = np.zeros(max_iters, np.float32)
        # One device_get over the tree: copy_to_host_async is issued for
        # both buffers before either host copy drains.
        elif self._collect:
            out_host, av_host = jax.device_get((out, av))
            out_host, av_host = np.asarray(out_host), np.asarray(av_host)
        else:
            out_host = np.asarray(jax.device_get(out))
            av_host = np.zeros(max_iters, np.float32)
        # The timed region is upload -> download (the reference's tic..toc,
        # ``d2q9-bgk.c:196-260``); the host-side fp64 field expansion below
        # happens after the fetch and is not device time.
        toc = time.perf_counter()
        if readback == "fields":
            out_host = expand_fields(
                out_host, self.obstacles, self.params.density
            )
        run_params = dataclasses.replace(self.params, max_iters=max_iters)
        return RunResult(
            params=run_params,
            f=out_host if readback in ("state", "device") else None,
            fields=out_host if readback == "fields" else None,
            av_vels=av_host,
            obstacles=self.obstacles,
            free_cells_inv=float(self.free_cells_inv),
            elapsed=toc - tic,
            steps_timed=max_iters,
        )

    def run_checkpointed(
        self,
        checkpoint_dir: str,
        every: int,
        max_iters: int | None = None,
        resume: bool = True,
    ) -> RunResult:
        """Run in ``every``-step segments, snapshotting resumable state
        (f, step index, av_vels so far) after each segment; picks up from
        an existing checkpoint in ``checkpoint_dir`` when ``resume``.

        The reference has no restart capability (SURVEY §5.4) — a crashed
        80k-step run starts over; this closes that gap.
        """
        if max_iters is None:
            max_iters = self.params.max_iters
        f, av, elapsed, executed = run_segments_checkpointed(
            # Device readback: f stays on the device between segments; the
            # v1 save gathers it once per snapshot (np.asarray inside
            # save).  A fresh start seeds f0 from the on-device
            # initializer so every segment (first included) runs the SAME
            # compiled f0-variant — one AOT compile per segment length.
            run_segment=lambda seg, f0: self.run(
                max_iters=seg,
                f0=f0 if f0 is not None else self.initial_state(),
                readback="device",
            ),
            precompile=functools.partial(self.compiled, from_f0=True),
            params=self.params,
            obstacles=self.obstacles,
            checkpoint_dir=checkpoint_dir,
            every=every,
            max_iters=max_iters,
            resume=resume,
        )
        if f is None:  # zero remaining work and nothing checkpointed
            return self.run(max_iters=0)
        if not isinstance(f, np.ndarray):
            # f is the last segment's on-device array, but the snapshot
            # committed just above holds exactly this state — read it
            # back from local disk instead of fetching the device array a
            # second time.
            from lbm_tpu import checkpoint as ckpt

            f = ckpt.load(checkpoint_dir).f
        return RunResult(
            params=dataclasses.replace(self.params, max_iters=max_iters),
            f=np.asarray(f),
            av_vels=av,
            obstacles=self.obstacles,
            free_cells_inv=float(self.free_cells_inv),
            elapsed=elapsed,
            steps_timed=executed,
        )


def run_segments_checkpointed(
    *,
    run_segment: Callable[[int, np.ndarray | None], Any],
    precompile: Callable[[int], Any],
    params: LBMParams,
    obstacles: np.ndarray,
    checkpoint_dir: str,
    every: int,
    max_iters: int,
    resume: bool,
    save_fn: Callable[..., Any] | None = None,
) -> tuple[np.ndarray | None, np.ndarray, float, int]:
    """Shared checkpointed-segment driver (single-chip and sharded runs).

    ``run_segment(seg, f0)`` must return an object with ``.f`` and
    ``.av_vels`` — ``.f`` may be an on-device array (``readback="device"``
    segments keep f off the host link between segments; only snapshots
    touch it); returns ``(f_final, av_vels, elapsed, steps_executed)``
    with ``f_final`` None when there was no work at all.
    ``steps_executed`` counts only THIS invocation's steps (a resume does
    not re-run the checkpointed prefix) — perf reporting must use it, not
    ``max_iters``.  ``save_fn(dir, params, obstacles, step, f, av)``
    writes each snapshot (default: the single-``.npz`` v1 writer; sharded
    callers pass :func:`lbm_tpu.checkpoint.save_sharded`).
    """
    from lbm_tpu import checkpoint as ckpt

    if save_fn is None:
        save_fn = ckpt.save
    if every <= 0:
        raise ValueError(f"checkpoint interval must be positive: {every}")

    start = 0
    av_parts: list[np.ndarray] = []
    f = None
    if resume:
        loaded = ckpt.load(checkpoint_dir)
        if loaded is not None:
            loaded.validate(params, obstacles)
            if loaded.step > max_iters:
                raise ValueError(
                    f"checkpoint at step {loaded.step} is beyond "
                    f"max_iters={max_iters}"
                )
            start = loaded.step
            av_parts.append(np.asarray(loaded.av_vels))
            f = loaded.f

    # Precompile every distinct segment length (at most two: ``every``
    # and the final remainder) so no AOT compile lands mid-run inside
    # the timed region.
    remaining = max_iters - start
    if remaining >= every:
        precompile(every)
    tail = remaining % every if remaining >= every else remaining
    if tail:
        precompile(tail)

    tic = time.perf_counter()
    step = start
    while step < max_iters:
        seg = min(every, max_iters - step)
        res = run_segment(seg, f)
        f = res.f
        av_parts.append(res.av_vels)
        step += seg
        save_fn(
            checkpoint_dir,
            params,
            obstacles,
            step,
            f,
            np.concatenate(av_parts) if av_parts else np.zeros(0),
        )
    elapsed = time.perf_counter() - tic

    av = (
        np.concatenate(av_parts) if av_parts else np.zeros(0, dtype=np.float32)
    )
    return f, av, elapsed, max_iters - start
