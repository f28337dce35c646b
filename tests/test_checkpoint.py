"""Checkpoint/resume: segmented runs must reproduce a continuous run."""

import dataclasses

import numpy as np
import pytest

from lbm_tpu import checkpoint as ckpt
from lbm_tpu.config import LBMParams
from lbm_tpu.geometry import channel_box
from lbm_tpu.runtime import Simulator

PARAMS = LBMParams(64, 32, 30, 10, 0.1, 0.005, 1.85)


def make_sim():
    return Simulator(PARAMS, channel_box(64, 32), kernel="reference")


def test_segmented_equals_continuous(tmp_path):
    cont = make_sim().run()
    seg = make_sim().run_checkpointed(tmp_path, every=7)
    np.testing.assert_array_equal(cont.f, seg.f)
    np.testing.assert_array_equal(cont.av_vels, seg.av_vels)
    saved = ckpt.load(tmp_path)
    assert saved.step == 30


def test_resume_from_partial(tmp_path):
    """Simulate a crash after 2 segments, resume, and match continuous."""
    sim = make_sim()
    sim.run_checkpointed(tmp_path, every=8, max_iters=16)  # "crashes" at 16
    assert ckpt.load(tmp_path).step == 16
    res = make_sim().run_checkpointed(tmp_path, every=8)  # resumes to 30
    cont = make_sim().run()
    np.testing.assert_array_equal(cont.f, res.f)
    np.testing.assert_array_equal(cont.av_vels, res.av_vels)
    assert ckpt.load(tmp_path).step == 30


def test_resume_rejects_wrong_mask(tmp_path):
    make_sim().run_checkpointed(tmp_path, every=10, max_iters=10)
    other = Simulator(
        PARAMS, channel_box(64, 32, interior_row=15), kernel="reference"
    )
    with pytest.raises(ValueError, match="mask"):
        other.run_checkpointed(tmp_path, every=10)


def test_resume_rejects_wrong_physics(tmp_path):
    """Altered density/accel/omega must not silently splice trajectories."""
    make_sim().run_checkpointed(tmp_path, every=10, max_iters=10)
    for field, value in (("omega", 1.5), ("accel", 0.01), ("density", 0.2)):
        params2 = dataclasses.replace(PARAMS, **{field: value})
        other = Simulator(params2, channel_box(64, 32), kernel="reference")
        with pytest.raises(ValueError, match=field):
            other.run_checkpointed(tmp_path, every=10)


def test_resume_rejects_wrong_grid(tmp_path):
    make_sim().run_checkpointed(tmp_path, every=10, max_iters=10)
    params2 = dataclasses.replace(PARAMS, nx=128)
    other = Simulator(params2, channel_box(128, 32), kernel="reference")
    with pytest.raises(ValueError, match="grid"):
        other.run_checkpointed(tmp_path, every=10)


def test_sharded_checkpoint_resume(tmp_path):
    """Sharded segmented runs resume to the same trajectory; the snapshot
    stores gathered global state, so the mesh size may even change."""
    import jax

    from lbm_tpu.parallel.sharded import ShardedSimulator, default_mesh

    if len(jax.devices()) < 4:
        pytest.skip("needs virtual devices")
    obstacles = channel_box(64, 32)
    cont = ShardedSimulator(PARAMS, obstacles, mesh=default_mesh(4)).run()
    sim = ShardedSimulator(PARAMS, obstacles, mesh=default_mesh(4))
    sim.run_checkpointed(tmp_path, every=8, max_iters=16)  # "crash" at 16
    # resume on a DIFFERENT mesh size
    res = ShardedSimulator(
        PARAMS, obstacles, mesh=default_mesh(2)
    ).run_checkpointed(tmp_path, every=8)
    np.testing.assert_array_equal(cont.f, res.f)
    np.testing.assert_allclose(cont.av_vels, res.av_vels, rtol=1e-5)
    assert ckpt.load(tmp_path).step == 30


@pytest.mark.parametrize("resume_mesh", [(2, 2), (4, 1), (2,)])
def test_sharded_2d_checkpoint_resume(tmp_path, resume_mesh):
    """Checkpoint/resume on a 2-D mesh: a run "crashed" at step 16 on a
    2x2 mesh resumes bit-exactly, on the same 2-D mesh or on another
    mesh shape (the per-shard snapshot reassembles the global state)."""
    import dataclasses

    import jax

    from lbm_tpu.parallel.sharded import (
        ShardedSimulator,
        default_mesh,
        default_mesh_2d,
    )

    if len(jax.devices()) < 4:
        pytest.skip("needs virtual devices")
    params = dataclasses.replace(PARAMS, ny=32, nx=64, max_iters=30)
    obstacles = channel_box(params.nx, params.ny, interior_col=33)

    def sim(shape):
        mesh = (default_mesh(*shape) if len(shape) == 1
                else default_mesh_2d(*shape))
        return ShardedSimulator(params, obstacles, mesh=mesh)

    cont = sim((2, 2)).run()
    sim((2, 2)).run_checkpointed(tmp_path, every=8, max_iters=16)  # "crash"
    res = sim(resume_mesh).run_checkpointed(tmp_path, every=8)
    np.testing.assert_array_equal(cont.f, res.f)
    np.testing.assert_allclose(cont.av_vels, res.av_vels, rtol=1e-5)
    assert res.steps_timed == 14
    assert ckpt.load(tmp_path).step == 30


def test_sharded_checkpoint_is_per_shard(tmp_path):
    """Sharded snapshots are one file per device slab (written from
    addressable_shards, never a gathered global array) plus a meta commit
    point — VERDICT r2 item 6."""
    import jax

    from lbm_tpu.parallel.sharded import ShardedSimulator, default_mesh

    if len(jax.devices()) < 4:
        pytest.skip("needs virtual devices")
    obstacles = channel_box(64, 32)
    sim = ShardedSimulator(PARAMS, obstacles, mesh=default_mesh(4))
    res = sim.run_checkpointed(tmp_path, every=30)
    assert (tmp_path / ckpt.META_FILENAME).exists()
    assert not (tmp_path / ckpt.FILENAME).exists()  # no v1 global npz
    shard_files = sorted(tmp_path.glob("lbm_checkpoint.step*.shard*.npz"))
    assert len(shard_files) == 4
    import json

    meta = json.loads((tmp_path / ckpt.META_FILENAME).read_text())
    assert meta["version"] == 2
    # each shard entry reports its slab geometry + bytes moved
    for e in meta["shards"]:
        assert e["shape"] == [9, 8, 64]  # ny=32 over 4 shards
        assert e["mbytes"] == round(9 * 8 * 64 * 4 / 1e6, 3)
    loaded = ckpt.load(tmp_path)
    assert loaded.step == 30
    np.testing.assert_array_equal(loaded.f, res.f)


def test_cross_format_resume(tmp_path):
    """A v2 (sharded) snapshot resumes on a single chip and a v1
    (single-chip) snapshot resumes on a mesh — same trajectory."""
    import jax

    from lbm_tpu.parallel.sharded import ShardedSimulator, default_mesh

    if len(jax.devices()) < 4:
        pytest.skip("needs virtual devices")
    obstacles = channel_box(64, 32)
    cont = make_sim().run()
    # sharded prefix (v2) -> single-chip tail
    d1 = tmp_path / "v2_to_v1"
    ShardedSimulator(PARAMS, obstacles, mesh=default_mesh(4)).run_checkpointed(
        d1, every=8, max_iters=16
    )
    assert (d1 / ckpt.META_FILENAME).exists()
    res = make_sim().run_checkpointed(d1, every=8)
    np.testing.assert_array_equal(cont.f, res.f)
    # single-chip prefix (v1) -> sharded tail; the v1 save also prunes any
    # stale v2 set so load() can't resurrect an older snapshot
    d2 = tmp_path / "v1_to_v2"
    make_sim().run_checkpointed(d2, every=8, max_iters=16)
    assert (d2 / ckpt.FILENAME).exists()
    res2 = ShardedSimulator(
        PARAMS, obstacles, mesh=default_mesh(2)
    ).run_checkpointed(d2, every=8)
    np.testing.assert_array_equal(cont.f, np.asarray(res2.f))
    assert not (d2 / ckpt.FILENAME).exists()  # superseded by the v2 set


def test_sharded_checkpoint_crash_atomicity(tmp_path):
    """A crash mid-snapshot (stray next-step shard files, no meta commit)
    must leave the previous complete snapshot loadable; the next commit
    prunes the strays."""
    import jax

    from lbm_tpu.parallel.sharded import ShardedSimulator, default_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs virtual devices")
    obstacles = channel_box(64, 32)
    sim = ShardedSimulator(PARAMS, obstacles, mesh=default_mesh(2))
    sim.run_checkpointed(tmp_path, every=8, max_iters=8)
    before = ckpt.load(tmp_path)
    assert before.step == 8
    # simulate a crash partway through writing the step-16 snapshot
    stray = tmp_path / "lbm_checkpoint.step16.shard0000.npz"
    stray.write_bytes(b"truncated garbage")
    loaded = ckpt.load(tmp_path)  # meta still points at the step-8 set
    assert loaded.step == 8
    np.testing.assert_array_equal(loaded.f, before.f)
    res = ShardedSimulator(
        PARAMS, obstacles, mesh=default_mesh(2)
    ).run_checkpointed(tmp_path, every=8)
    assert ckpt.load(tmp_path).step == 30
    assert not stray.exists()  # pruned by the committed snapshot
    cont = make_sim().run()
    np.testing.assert_array_equal(cont.f, np.asarray(res.f))


def test_sharded_av_crash_window(tmp_path):
    """The av file is written BEFORE the meta commit: a crash between the
    two renames leaves a NEWER av beside the older committed meta.  Load
    must truncate av to the committed step (or the resumed run would
    duplicate the uncommitted steps' av entries); a SHORTER av means a
    corrupt/foreign file and must fail loudly."""
    import jax

    from lbm_tpu.parallel.sharded import ShardedSimulator, default_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs virtual devices")
    obstacles = channel_box(64, 32)
    ShardedSimulator(PARAMS, obstacles, mesh=default_mesh(2)).run_checkpointed(
        tmp_path, every=8, max_iters=8
    )
    committed = ckpt.load(tmp_path)
    assert committed.step == 8 and committed.av_vels.shape == (8,)
    # Crash window: av from the (uncommitted) step-16 snapshot.
    longer = np.arange(16, dtype=np.float32)
    longer[:8] = committed.av_vels
    with open(tmp_path / ckpt.AV_FILENAME, "wb") as fp:
        np.savez(fp, av_vels=longer)
    loaded = ckpt.load(tmp_path)
    assert loaded.step == 8
    np.testing.assert_array_equal(loaded.av_vels, committed.av_vels)
    # Corrupt: av shorter than the committed step.
    with open(tmp_path / ckpt.AV_FILENAME, "wb") as fp:
        np.savez(fp, av_vels=longer[:4])
    with pytest.raises(ValueError, match="av stream"):
        ckpt.load(tmp_path)


def test_sharded_load_rejects_missing_shard(tmp_path):
    """A meta referencing an absent/incomplete shard set fails loudly
    instead of resuming from a hole-filled state."""
    import jax

    from lbm_tpu.parallel.sharded import ShardedSimulator, default_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs virtual devices")
    obstacles = channel_box(64, 32)
    ShardedSimulator(PARAMS, obstacles, mesh=default_mesh(2)).run_checkpointed(
        tmp_path, every=8, max_iters=8
    )
    victim = sorted(tmp_path.glob("lbm_checkpoint.step*.shard*.npz"))[0]
    victim.unlink()
    with pytest.raises((ValueError, FileNotFoundError)):
        ckpt.load(tmp_path)


@pytest.mark.parametrize(
    "seed",
    [
        0,
        pytest.param(1, marks=pytest.mark.medium),
        pytest.param(2, marks=pytest.mark.medium),
    ],
)
def test_random_crash_resume_cycles(tmp_path, seed):
    """Property: any sequence of 'crashes' at random segment boundaries
    resumes to the exact continuous trajectory."""
    rng = np.random.default_rng(seed)
    cont = make_sim().run()
    every = int(rng.integers(3, 12))
    d = tmp_path / f"ck{seed}"
    # crash after 1..3 partial runs with random partial lengths, then finish
    progress = 0
    for _ in range(int(rng.integers(1, 4))):
        if progress >= 30:
            break
        stop = int(rng.integers(progress + 1, 31))
        make_sim().run_checkpointed(d, every=every, max_iters=stop)
        progress = stop
    res = make_sim().run_checkpointed(d, every=every)
    np.testing.assert_array_equal(cont.f, res.f)
    np.testing.assert_array_equal(cont.av_vels, res.av_vels)


def test_resume_reports_only_executed_steps(tmp_path):
    """A resumed run's perf accounting must not credit the pre-crash
    steps to this invocation (mlups was inflated ~N x before)."""
    make_sim().run_checkpointed(tmp_path, every=10, max_iters=20)
    res = make_sim().run_checkpointed(tmp_path, every=10)  # resumes 20->30
    assert res.params.max_iters == 30  # full trajectory length
    assert res.steps_timed == 10  # but only 10 steps ran here
    assert res.av_vels.shape == (30,)
    # resuming an already-complete run executes nothing
    res2 = make_sim().run_checkpointed(tmp_path, every=10)
    assert res2.steps_timed == 0
    assert res2.mlups == 0 or res2.elapsed == 0


def test_checkpoint_beyond_max_iters(tmp_path):
    make_sim().run_checkpointed(tmp_path, every=10, max_iters=20)
    with pytest.raises(ValueError, match="beyond"):
        make_sim().run_checkpointed(tmp_path, every=10, max_iters=10)


def test_load_missing_returns_none(tmp_path):
    assert ckpt.load(tmp_path) is None


def test_save_rejects_short_av(tmp_path):
    """An av stream shorter than the committed step would shift later av
    rows off their timestep on resume — both writers must refuse."""
    import jax.numpy as jnp

    obs = channel_box(64, 32)  # (nx, ny) -> mask [ny=32, nx=64]
    f = np.zeros((9, 32, 64), np.float32)  # [9, ny, nx]
    short_av = np.zeros(5, np.float32)
    with pytest.raises(ValueError, match="av_vels has 5"):
        ckpt.save(tmp_path, PARAMS, obs, 10, f, short_av)
    with pytest.raises(ValueError, match="av_vels has 5"):
        ckpt.save_sharded(tmp_path, PARAMS, obs, 10, jnp.asarray(f), short_av)
    assert ckpt.load(tmp_path) is None  # nothing committed


def test_v1_load_rejects_short_av(tmp_path):
    """A forged/corrupt v1 snapshot whose av stream is shorter than its
    committed step must fail loudly, like the v2 loader does."""
    import dataclasses as dc
    import json

    obs = channel_box(64, 32)
    header = json.dumps(
        {
            "params": dc.asdict(PARAMS),
            "step": 10,
            "mask_digest": ckpt._mask_digest(obs),
            "version": 1,
        }
    )
    with open(tmp_path / ckpt.FILENAME, "wb") as fp:
        np.savez(
            fp,
            header=np.frombuffer(header.encode(), dtype=np.uint8),
            f=np.zeros((9, 32, 64), np.float32),
            av_vels=np.zeros(5, np.float32),
        )
    with pytest.raises(ValueError, match="av stream has 5"):
        ckpt.load(tmp_path)


def test_sharded_load_accepts_nan_state(tmp_path):
    """A structurally complete snapshot of a DIVERGED run (NaN in f) must
    load — coverage is tracked with an explicit tile mask, not a NaN
    sentinel, so a legitimate non-finite state isn't misreported as
    'missing shard files'."""
    import jax
    import jax.numpy as jnp

    from lbm_tpu.parallel.sharded import AXIS, NamedSharding, P, default_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs virtual devices")
    obstacles = channel_box(64, 32)
    mesh = default_mesh(2)
    f = np.random.default_rng(0).standard_normal((9, 32, 64)).astype(np.float32)
    f[4, 17, 3] = np.nan  # the diverged cell
    f_dev = jax.device_put(
        jnp.asarray(f), NamedSharding(mesh, P(None, AXIS, None))
    )
    av = np.zeros(8, np.float32)
    ckpt.save_sharded(tmp_path, PARAMS, obstacles, 8, f_dev, av)
    loaded = ckpt.load(tmp_path)
    assert loaded is not None and loaded.step == 8
    np.testing.assert_array_equal(loaded.f, f)  # NaN included, bit-exact


def test_load_prefers_newer_step_across_formats(tmp_path):
    """A save that switched layouts and crashed right after its commit
    rename — before pruning the other layout's (older) set — must
    resume from the NEWER snapshot: load() resolves v1-vs-v2 by
    committed step, not by format preference."""
    import shutil

    import jax.numpy as jnp

    obs = channel_box(64, 32)
    rng = np.random.default_rng(1)
    f8 = rng.standard_normal((9, 32, 64)).astype(np.float32)
    f16 = rng.standard_normal((9, 32, 64)).astype(np.float32)
    av16 = np.arange(16, dtype=np.float32)

    # v2 committed at step 8, then a v1 save at step 16 whose stale-v2
    # prune "crashed" (simulated by writing the v1 file elsewhere and
    # copying only the committed snapshot in).
    ckpt.save_sharded(tmp_path, PARAMS, obs, 8, jnp.asarray(f8), av16[:8])
    side = tmp_path / "side"
    ckpt.save(side, PARAMS, obs, 16, f16, av16)
    shutil.copy(side / ckpt.FILENAME, tmp_path / ckpt.FILENAME)
    loaded = ckpt.load(tmp_path)
    assert loaded.step == 16
    np.testing.assert_array_equal(loaded.f, f16)

    # Mirror image: stale v1 at a LOWER step than the committed v2.
    d2 = tmp_path / "v2newer"
    ckpt.save(d2, PARAMS, obs, 8, f8, av16[:8])
    v1_file = (d2 / ckpt.FILENAME).read_bytes()
    ckpt.save_sharded(d2, PARAMS, obs, 16, jnp.asarray(f16), av16)
    (d2 / ckpt.FILENAME).write_bytes(v1_file)  # resurrect the stale v1
    loaded = ckpt.load(d2)
    assert loaded.step == 16
    np.testing.assert_array_equal(loaded.f, f16)


def test_committed_save_prunes_orphaned_tmp_files(tmp_path):
    """A crash mid-save leaves ``*.tmp`` staging files (step-stamped,
    multi-hundred-MB at giant grids); the next COMMITTED save of either
    layout must collect them, or crash/resume cycles accumulate
    unbounded dead bytes."""
    import jax.numpy as jnp

    obs = channel_box(64, 32)
    f = np.zeros((9, 32, 64), np.float32)
    av = np.zeros(8, np.float32)
    orphans = [
        tmp_path / "lbm_checkpoint.step4.shard0000.npz.tmp",
        tmp_path / (ckpt.AV_FILENAME + ".tmp"),
        tmp_path / (ckpt.META_FILENAME + ".tmp"),
    ]
    tmp_path.mkdir(exist_ok=True)
    for p in orphans:
        p.write_bytes(b"crashed mid-write")
    ckpt.save_sharded(tmp_path, PARAMS, obs, 8, jnp.asarray(f), av)
    for p in orphans:
        assert not p.exists(), f"orphan survived the v2 commit: {p.name}"
    assert ckpt.load(tmp_path).step == 8

    for p in orphans:
        p.write_bytes(b"crashed mid-write")
    ckpt.save(tmp_path, PARAMS, obs, 8, f, av)
    for p in orphans:
        assert not p.exists(), f"orphan survived the v1 commit: {p.name}"
    assert ckpt.load(tmp_path).step == 8


@pytest.mark.slow
@pytest.mark.parametrize(
    "extra, banner",
    [
        # 1-D mesh over 2x2 devices; the worker resumes on a 2-D (2,2)
        # mesh, so the 1-D run also proves cross-mesh shard re-sharding.
        ([], "PASS: 2 processes x 2 devices (1-D mesh)"),
        # Pod-shaped: 2 processes x 4 local devices (VERDICT r4 #6).
        (
            ["--procs", "2", "--local-devices", "4"],
            "PASS: 2 processes x 4 devices (1-D mesh)",
        ),
        # 2-D (Py x Px) mesh SPANNING both processes: exercises the
        # _shard_filename (y0, x0) offset math under multi-process 2-D
        # sharding; the worker resumes it on a 1-D mesh (cross-format).
        (
            ["--mesh", "2x2"],
            "PASS: 2 processes x 2 devices (mesh 2x2)",
        ),
    ],
    ids=["1d-2x2", "1d-2x4", "2d-2x2"],
)
def test_multihost_smoke(extra, banner):
    """REAL 2-process mesh (jax.distributed over localhost, CPU devices):
    the sharded SPMD program runs across processes, v2 checkpointing
    writes per-process shard files with a cross-process meta commit
    whose (y0, x0) offsets sit on the mesh's slab lattice, and a resume
    is bit-continuous — including onto a DIFFERENT mesh shape
    (tools/multihost_smoke.py; validates the multi-host wording in
    lbm_tpu/checkpoint.py — SURVEY §5.8)."""
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, str(repo / "tools" / "multihost_smoke.py"), *extra],
        capture_output=True,
        text=True,
        timeout=900,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert banner in proc.stdout
