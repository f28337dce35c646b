"""Pin the step's per-cell arithmetic op count by TRACING the kernel's
collision math (``ops/triton_step.collide_planes``), so the perf-model
constant in ``utils/profiling`` is anchored to the code, not to a comment
that can drift when the collision math changes."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from lbm_tpu.ops.triton_step import collide_planes


def _per_cell_op_counts(ty: int = 8, tx: int = 128) -> dict[str, float]:
    """Per-cell primitive-op counts of the collision stage (mask compare +
    ``collide_planes`` + the masked |u|), from walking the jaxpr."""

    def step_math(planes, fluid8):
        return collide_planes(list(planes), fluid8 != 0, jnp.float32(1.85))

    planes = [jnp.zeros((ty, tx), jnp.float32)] * 9
    fluid8 = jnp.zeros((ty, tx), jnp.int8)
    jaxpr = jax.make_jaxpr(step_math)(planes, fluid8)

    counts: dict[str, float] = {}

    def walk(jx):
        for eqn in jx.eqns:
            if "jaxpr" in eqn.params:  # nested (p)jit, e.g. jnp.where
                inner = eqn.params["jaxpr"]
                walk(inner.jaxpr if hasattr(inner, "jaxpr") else inner)
                continue
            shape = eqn.outvars[0].aval.shape
            n = int(np.prod(shape)) if shape else 1
            name = eqn.primitive.name
            counts[name] = counts.get(name, 0.0) + n / (ty * tx)

    walk(jaxpr.jaxpr)
    return counts


def test_collide_per_cell_op_count_is_pinned():
    """The traced per-cell blend of the collision stage.  If this fails
    after a deliberate math change, update this pin and
    ``utils/profiling.FLOPS_PER_CELL``."""
    c = _per_cell_op_counts()
    arith = c.get("add", 0) + c.get("sub", 0) + c.get("mul", 0)
    assert (c["mul"], c["add"], c["sub"]) == (35, 31, 25)
    assert arith == 91
    assert c["select_n"] == 10  # 9 bounce-back wheres + the |u| mask
    assert c["ne"] == 1  # fluid-mask compare
    assert c["div"] == 1  # 1/rho
    assert c["sqrt"] == 1  # |u|
    issue_ops = arith + c["select_n"] + c["ne"] + c["div"] + c["sqrt"]
    assert issue_ops == 104


def test_flops_per_cell_reporting_constant_is_sane():
    """utils/profiling.FLOPS_PER_CELL (the MLUPS->GFLOP/s conversion) must
    bracket the traced collision count plus the streaming index math —
    between the pure-collide 104 and 1.5x it."""
    from lbm_tpu.utils.profiling import FLOPS_PER_CELL

    assert 104 <= FLOPS_PER_CELL <= 156
