"""Multi-device spatial sharding: a sharded grid with per-step halo exchange.

The reference is a single-device code; its scaling story stops at one GPU
(SURVEY §2 parallelism table).  This module adds the scale-out:
``f[9, ny, nx]`` is sharded by rows across a 1-D ``jax.sharding.Mesh``
axis ``"y"`` (or by tiles over a 2-D ``(y, x)`` mesh), and each timestep
exchanges one ghost row (and column) per direction with ``lax.ppermute``,
which XLA hands to NCCL on GPUs, then runs the jnp physics locally.  The
per-step mean-speed reduction becomes a ``lax.psum``.  The cards of one
host are joined all to all, so the mesh shape follows the grid alone.

The whole run (the ``lax.scan`` over timesteps) lives *inside* one
``shard_map``, so the entire multi-device simulation is a single SPMD XLA
program: no host round-trips, collectives compiled into the loop body —
the distributed analog of the reference's "enqueue 40k kernels, sync once"
contract (``d2q9-bgk.c:221-240``).

Correctness notes:

* Fully-periodic wrap in y is the ring permutation itself: device 0's
  south ghost is device P-1's last row.
* The body-force row ``ny-2`` lives on device P-1 (requires local
  ``ny/P >= 3`` so its streaming readers are local too); the kick is
  applied with a uniform row-index mask so the SPMD program stays
  identical across devices.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lbm_tpu.config import LBMParams
from lbm_tpu.diagnostics import ResultMetrics
from lbm_tpu.runtime import enable_compile_cache
from lbm_tpu.geometry import free_cells_of
from lbm_tpu.ops.lattice import CX, CY, NSPEEDS, kick_scale
from lbm_tpu.ops.reference import accel_weights, collide, init_cells

AXIS = "y"


class _LoweredWithConsts:
    """Adapter so a factory whose program takes ``(f, *consts)`` still
    presents the single-argument ``run.lower(spec).compile()(f)`` protocol
    ``ShardedSimulator.compiled`` uses.  The consts (the fluid mask) ride
    as runtime ARGUMENTS rather than HLO literals, which would make the
    compiled module and its cache key grow with the grid (see
    ``lbm_tpu.ops.program.StepProgram.consts``)."""

    def __init__(self, lowered, consts):
        self._lowered = lowered
        self._consts = consts

    def compile(self):
        exe = self._lowered.compile()
        consts = self._consts
        return lambda f: exe(f, *consts)


def default_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` (all by default).

    Raises when fewer devices exist than requested — silently clamping
    would hand back a smaller mesh and the caller would run (and report)
    the wrong topology.
    """
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devs)} devices are available"
            )
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (AXIS,))


def _halo_exchange(f_loc: jax.Array, n_shards: int) -> tuple[jax.Array, jax.Array]:
    """Ring-exchange the boundary rows.

    Returns ``(ghost_s, ghost_n)``: the global rows just below/above this
    shard's slab — one ``ppermute`` each way around the ring.
    """
    if n_shards == 1:
        return f_loc[:, -1:, :], f_loc[:, :1, :]
    down, up = _rings(n_shards)
    ghost_s = jax.lax.ppermute(f_loc[:, -1:, :], AXIS, down)
    ghost_n = jax.lax.ppermute(f_loc[:, :1, :], AXIS, up)
    return ghost_s, ghost_n


def _stream_with_ghosts(
    f_loc: jax.Array, ghost_s: jax.Array, ghost_n: jax.Array
) -> jax.Array:
    """Pull-streaming on a row slab with explicit ghost rows."""
    ny_loc = f_loc.shape[1]
    ext = jnp.concatenate([ghost_s, f_loc, ghost_n], axis=1)
    return jnp.stack(
        [
            jnp.roll(
                ext[k, 1 - int(CY[k]) : 1 - int(CY[k]) + ny_loc, :],
                int(CX[k]),
                axis=1,
            )
            for k in range(NSPEEDS)
        ]
    )


def _accelerate_masked(
    f_loc: jax.Array,
    fluid_loc: jax.Array,
    row_is_kick: jax.Array,  # [ny_loc, 1] bool: local row == global ny-2
    w1: np.float32,
    w2: np.float32,
) -> jax.Array:
    """Body force with a uniform row mask (same program on every device)."""
    ok = (
        row_is_kick
        & fluid_loc
        & (f_loc[3] - w1 > 0.0)
        & (f_loc[6] - w2 > 0.0)
        & (f_loc[7] - w2 > 0.0)
    )
    okf = jnp.where(ok, jnp.float32(1.0), jnp.float32(0.0))
    updates = []
    for k in range(NSPEEDS):
        s = kick_scale(k, w1, w2)
        updates.append(f_loc[k] if s is None else f_loc[k] + okf * s)
    return jnp.stack(updates)


def _rings(n: int) -> tuple[list[tuple[int, int]], list[tuple[int, int]]]:
    """(down, up) neighbor pairs for a ring ``ppermute`` over an n-device
    mesh axis — the single definition both sharded factories use."""
    down = [(i, (i + 1) % n) for i in range(n)]
    up = [(i, (i - 1) % n) for i in range(n)]
    return down, up


def make_sharded_run(
    params: LBMParams,
    obstacles: np.ndarray,
    free_cells_inv: np.float32,
    mesh: Mesh,
    max_iters: int | None = None,
) -> Callable[[jax.Array], tuple[jax.Array, jax.Array]]:
    """Build ``run(f_global) -> (f_final_global, av_vels)`` — one SPMD
    program containing the full time loop over the mesh."""
    if max_iters is None:
        max_iters = params.max_iters
    n_shards = mesh.shape[AXIS]
    ny, nx = params.ny, params.nx
    if ny % n_shards != 0:
        raise ValueError(f"ny={ny} not divisible by mesh size {n_shards}")
    ny_loc = ny // n_shards
    if ny_loc < 3:
        raise ValueError(
            f"need >= 3 rows per shard (ny={ny}, shards={n_shards})"
        )
    omega = np.float32(params.omega)
    w1, w2 = accel_weights(params)
    fcinv = np.float32(free_cells_inv)

    def local_run(f_loc: jax.Array, fluid_loc: jax.Array):
        shard = jax.lax.axis_index(AXIS)
        row0 = shard * ny_loc
        local_rows = jax.lax.broadcasted_iota(jnp.int32, (ny_loc, 1), 0)
        row_is_kick = (local_rows + row0) == (ny - 2)

        def body(f, _):
            f = _accelerate_masked(f, fluid_loc, row_is_kick, w1, w2)
            ghost_s, ghost_n = _halo_exchange(f, n_shards)
            tmp = _stream_with_ghosts(f, ghost_s, ghost_n)
            f_new, tot_u = collide(tmp, fluid_loc, omega)
            av = jax.lax.psum(tot_u, AXIS) * fcinv
            return f_new, av

        return jax.lax.scan(body, f_loc, None, length=max_iters)

    sharded = jax.shard_map(
        local_run,
        mesh=mesh,
        in_specs=(P(None, AXIS, None), P(AXIS, None)),
        out_specs=(P(None, AXIS, None), P()),
    )

    # The fluid mask enters as a runtime ARGUMENT (committed to the mesh
    # here), never an HLO literal (see _LoweredWithConsts).
    fluid_dev = jax.device_put(
        ~np.asarray(obstacles, dtype=bool),
        NamedSharding(mesh, P(AXIS, None)),
    )

    @functools.partial(jax.jit, donate_argnums=0)
    def run_base(f_global: jax.Array, fluid: jax.Array):
        return sharded(f_global, fluid)

    def run(f_global: jax.Array):
        return run_base(f_global, fluid_dev)

    run.lower = lambda spec: _LoweredWithConsts(
        run_base.lower(spec, fluid_dev), (fluid_dev,)
    )
    return run


AXIS_X = "x"


def default_mesh_2d(py: int, px: int) -> Mesh:
    """2-D mesh (rows x cols) over the first py*px devices."""
    devs = jax.devices()
    if py * px > len(devs):
        raise ValueError(
            f"requested a {py}x{px} mesh but only {len(devs)} devices "
            "are available"
        )
    return Mesh(np.array(devs[: py * px]).reshape(py, px), (AXIS, AXIS_X))


def make_sharded_2d_run(
    params: LBMParams,
    obstacles: np.ndarray,
    free_cells_inv: np.float32,
    mesh: Mesh,
    max_iters: int | None = None,
) -> Callable[[jax.Array], tuple[jax.Array, jax.Array]]:
    """2-D spatial decomposition: grid tiles sharded over a (y, x) mesh.

    Halo exchange is the classic two-phase scheme: rows first (one
    ``ppermute`` each way over the ``y`` ring), then columns of the
    row-extended slab (one ``ppermute`` each way over the ``x`` ring) —
    the column phase carries the corner cells the diagonal speeds need.
    Streaming then becomes pure static slices of the (nyl+2, nxl+2)
    extended tile; the av reduction is a ``psum`` over both axes.
    """
    if max_iters is None:
        max_iters = params.max_iters
    py, px = mesh.shape[AXIS], mesh.shape[AXIS_X]
    ny, nx = params.ny, params.nx
    if ny % py != 0 or nx % px != 0:
        raise ValueError(f"grid {ny}x{nx} not divisible by mesh {py}x{px}")
    nyl, nxl = ny // py, nx // px
    if nyl < 3 or nxl < 2:
        raise ValueError(f"tiles too thin: {nyl}x{nxl} (need >=3 rows, >=2 cols)")
    omega = np.float32(params.omega)
    w1, w2 = accel_weights(params)
    fcinv = np.float32(free_cells_inv)
    ring_y, ring_y_up = _rings(py)
    ring_x, ring_x_up = _rings(px)

    def local_run(f_loc: jax.Array, fluid_loc: jax.Array):
        yshard = jax.lax.axis_index(AXIS)
        row0 = yshard * nyl
        local_rows = jax.lax.broadcasted_iota(jnp.int32, (nyl, 1), 0)
        row_is_kick = (local_rows + row0) == (ny - 2)

        def exchange(f):
            gs = f[:, -1:, :] if py == 1 else jax.lax.ppermute(
                f[:, -1:, :], AXIS, ring_y
            )
            gn = f[:, :1, :] if py == 1 else jax.lax.ppermute(
                f[:, :1, :], AXIS, ring_y_up
            )
            ext_y = jnp.concatenate([gs, f, gn], axis=1)
            gw = ext_y[:, :, -1:] if px == 1 else jax.lax.ppermute(
                ext_y[:, :, -1:], AXIS_X, ring_x
            )
            ge = ext_y[:, :, :1] if px == 1 else jax.lax.ppermute(
                ext_y[:, :, :1], AXIS_X, ring_x_up
            )
            return jnp.concatenate([gw, ext_y, ge], axis=2)

        def body(f, _):
            f = _accelerate_masked(f, fluid_loc, row_is_kick, w1, w2)
            ext = exchange(f)
            tmp = jnp.stack(
                [
                    ext[
                        k,
                        1 - int(CY[k]) : 1 - int(CY[k]) + nyl,
                        1 - int(CX[k]) : 1 - int(CX[k]) + nxl,
                    ]
                    for k in range(NSPEEDS)
                ]
            )
            f_new, tot_u = collide(tmp, fluid_loc, omega)
            av = jax.lax.psum(tot_u, (AXIS, AXIS_X)) * fcinv
            return f_new, av

        return jax.lax.scan(body, f_loc, None, length=max_iters)

    sharded = jax.shard_map(
        local_run,
        mesh=mesh,
        in_specs=(P(None, AXIS, AXIS_X), P(AXIS, AXIS_X)),
        out_specs=(P(None, AXIS, AXIS_X), P()),
    )

    # Runtime operand, not an HLO literal — see make_sharded_run.
    fluid_dev = jax.device_put(
        ~np.asarray(obstacles, dtype=bool),
        NamedSharding(mesh, P(AXIS, AXIS_X)),
    )

    @functools.partial(jax.jit, donate_argnums=0)
    def run_base(f_global: jax.Array, fluid: jax.Array):
        return sharded(f_global, fluid)

    def run(f_global: jax.Array):
        return run_base(f_global, fluid_dev)

    run.lower = lambda spec: _LoweredWithConsts(
        run_base.lower(spec, fluid_dev), (fluid_dev,)
    )
    return run

@dataclasses.dataclass
class ShardedRunResult(ResultMetrics):
    params: LBMParams
    f: np.ndarray | None
    av_vels: np.ndarray
    obstacles: np.ndarray
    free_cells_inv: float
    elapsed: float
    n_shards: int
    fields: np.ndarray | None = None  # [4, ny, nx] when readback="fields"
    steps_timed: int | None = None  # see RunResult.steps_timed


class ShardedSimulator:
    """Multi-device simulator over a 1-D (rows) or 2-D (rows x cols) mesh,
    running the jnp step on every shard (weak-scaling path,
    BASELINE.json configs[4])."""

    def __init__(
        self,
        params: LBMParams,
        obstacles: np.ndarray,
        mesh: Mesh | None = None,
    ) -> None:
        self.params = params
        self.obstacles = np.asarray(obstacles, dtype=bool)
        if self.obstacles.shape != (params.ny, params.nx):
            raise ValueError(
                f"obstacle mask {self.obstacles.shape} != grid "
                f"{(params.ny, params.nx)}"
            )
        self.mesh = mesh if mesh is not None else default_mesh()
        enable_compile_cache()
        self.free_cells = free_cells_of(self.obstacles)
        self.free_cells_inv = np.float32(1.0) / np.float32(self.free_cells)
        self._compiled: dict[int, Callable] = {}
        self._finalize = None
        self._init_compiled = None

    @property
    def _f_spec(self) -> P:
        if AXIS_X in self.mesh.shape:
            return P(None, AXIS, AXIS_X)
        return P(None, AXIS, None)

    def compiled(self, max_iters: int | None = None):
        """AOT-compile (and cache) the sharded full-run program; like
        ``Simulator.compiled``, compilation happens here, outside the
        timed region."""
        if max_iters is None:
            max_iters = self.params.max_iters
        if max_iters not in self._compiled:
            factory = (
                make_sharded_2d_run if AXIS_X in self.mesh.shape
                else make_sharded_run
            )
            run = factory(
                self.params,
                self.obstacles,
                self.free_cells_inv,
                self.mesh,
                max_iters,
            )
            spec = jax.ShapeDtypeStruct(
                (NSPEEDS, self.params.ny, self.params.nx),
                jnp.float32,
                sharding=NamedSharding(self.mesh, self._f_spec),
            )
            self._compiled[max_iters] = run.lower(spec).compile()
        return self._compiled[max_iters]

    def run(
        self,
        max_iters: int | None = None,
        readback: str = "state",
        f0: np.ndarray | None = None,
    ) -> ShardedRunResult:
        """``readback="fields"`` computes the compact
        ``[u_x, u_y, rho - density]`` float16 payload on the mesh
        (elementwise over the existing sharding — no resharding) and
        fetches those 3 half-precision planes instead of the 9 fp32
        f-planes; |u| and pressure are reconstructed on host in fp64
        (encoding + error bounds: ``runtime.raw_fields_fn`` /
        ``expand_fields``)."""
        from lbm_tpu.runtime import check_readback, expand_fields, raw_fields_fn

        check_readback(readback)
        if max_iters is None:
            max_iters = self.params.max_iters
        fn = self.compiled(max_iters)
        sharding = NamedSharding(self.mesh, self._f_spec)
        finalize = None
        if readback == "fields":
            if self._finalize is None:
                # AOT-compile the field derivation outside the timed
                # region, like the step program itself; cached (the grid
                # and mesh are fixed per simulator).  The fluid mask is a
                # runtime OPERAND (device-put onto the mesh with f's
                # spatial sharding), never a jit closure constant (the
                # mask-literal rule, see runtime.raw_fields_fn).
                spec = jax.ShapeDtypeStruct(
                    (NSPEEDS, self.params.ny, self.params.nx),
                    jnp.float32,
                    sharding=sharding,
                )
                fluid_sharding = NamedSharding(
                    self.mesh, P(*sharding.spec[1:])
                )
                fluid_spec = jax.ShapeDtypeStruct(
                    (self.params.ny, self.params.nx),
                    jnp.bool_,
                    sharding=fluid_sharding,
                )
                exe = (
                    jax.jit(raw_fields_fn(self.params, self.obstacles))
                    .lower(spec, fluid_spec)
                    .compile()
                )
                fluid_dev = jax.device_put(
                    ~np.asarray(self.obstacles, dtype=bool), fluid_sharding
                )
                self._finalize = functools.partial(
                    (lambda _e, _m, f: _e(f, _m)), exe, fluid_dev
                )
            finalize = self._finalize
        if self._init_compiled is None:
            # On-device constant f0 (no host array, no upload), compiled
            # outside the timed region.
            self._init_compiled = (
                jax.jit(
                    functools.partial(init_cells, self.params),
                    out_shardings=sharding,
                )
                .lower()
                .compile()
            )

        tic = time.perf_counter()
        if f0 is None:
            f0 = self._init_compiled()
        elif isinstance(f0, jax.Array):
            # Already on device (checkpointed segments feed the previous
            # segment's sharded f straight back in) — re-lay it out on the
            # mesh without a host roundtrip.
            if f0.dtype != jnp.float32:
                f0 = f0.astype(jnp.float32)
            f0 = jax.device_put(f0, sharding)
        else:
            # Direct host->mesh upload: jnp.asarray first would
            # materialize the full global array on the DEFAULT device and
            # pay a device-to-device re-shard copy on top.  Same hazard/fix
            # as Simulator.run's from_f0 upload.
            f0 = jax.device_put(np.asarray(f0, np.float32), sharding)
        f_fin, av = fn(f0)
        if readback == "device":
            # f stays sharded on the mesh (checkpointed segments feed it
            # straight to the next segment / the per-shard snapshot
            # writer); av depends on every step, so fetching it is the
            # sync point.  av is fully replicated (out_specs P()) but on a
            # multi-process mesh it still SPANS non-addressable devices,
            # which jax refuses to fetch whole — read the local copy
            # (every process holds a complete one).  This is the readback
            # multi-host runs use (state/fields readbacks gather the
            # global f and are single-controller only).
            out_host = f_fin
            if av.is_fully_addressable:
                av_host = np.asarray(jax.device_get(av))
            else:
                av_host = np.asarray(av.addressable_shards[0].data)
        else:
            out_host, av_host = jax.device_get(
                (finalize(f_fin) if finalize else f_fin, av)
            )
            out_host, av_host = np.asarray(out_host), np.asarray(av_host)
        # Timer stops when the download drains; the host-side fp64 field
        # expansion is not device time (same contract as Simulator.run).
        toc = time.perf_counter()
        if readback == "fields":
            out_host = expand_fields(
                out_host, self.obstacles, self.params.density
            )
        return ShardedRunResult(
            params=dataclasses.replace(self.params, max_iters=max_iters),
            f=out_host if readback in ("state", "device") else None,
            fields=out_host if readback == "fields" else None,
            av_vels=av_host,
            obstacles=self.obstacles,
            free_cells_inv=float(self.free_cells_inv),
            elapsed=toc - tic,
            n_shards=self.mesh.shape[AXIS],
            steps_timed=max_iters,
        )

    def run_checkpointed(
        self,
        checkpoint_dir: str,
        every: int,
        max_iters: int | None = None,
        resume: bool = True,
    ) -> ShardedRunResult:
        """Segmented sharded run with checkpoint/resume (same contract as
        ``Simulator.run_checkpointed``).  Snapshots are PER-SHARD
        (:func:`lbm_tpu.checkpoint.save_sharded`): each device's slab is
        written from ``addressable_shards`` without gathering the global
        array, which also lets every process of a multi-host mesh write
        only its local slabs.  f stays ON DEVICE between segments
        (``readback="device"``).  Resume reassembles the global array on
        host and re-shards, so a run can resume on a different mesh
        shape."""
        from lbm_tpu import checkpoint as ckpt
        from lbm_tpu.runtime import run_segments_checkpointed

        if max_iters is None:
            max_iters = self.params.max_iters
        f, av, elapsed, executed = run_segments_checkpointed(
            run_segment=lambda seg, f0: self.run(
                max_iters=seg, f0=f0, readback="device"
            ),
            precompile=self.compiled,
            params=self.params,
            obstacles=self.obstacles,
            checkpoint_dir=checkpoint_dir,
            every=every,
            max_iters=max_iters,
            resume=resume,
            save_fn=ckpt.save_sharded,
        )
        if f is None:
            return self.run(max_iters=0)
        if not isinstance(f, np.ndarray):
            # f is still sharded on the mesh, but the per-shard snapshot
            # committed just above holds exactly this state — reassemble
            # it from the local shard files instead of gathering the
            # global device array a second time.
            f = ckpt.load(checkpoint_dir).f
        return ShardedRunResult(
            params=dataclasses.replace(self.params, max_iters=max_iters),
            f=np.asarray(f),
            av_vels=av,
            obstacles=self.obstacles,
            free_cells_inv=float(self.free_cells_inv),
            elapsed=elapsed,
            n_shards=self.mesh.shape[AXIS],
            steps_timed=executed,
        )
