"""The step-program protocol the drivers scan over, and its jnp instance.

This module imports no kernel code: the plain-jnp path never pulls in
Pallas.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from lbm_tpu.config import LBMParams
from lbm_tpu.ops.reference import make_masked_step_fn


@dataclasses.dataclass(frozen=True)
class StepProgram:
    """A step protocol whose scan carry is an opaque state pytree.

    ``init(f0, *consts) -> carry``; ``step(carry) -> (carry, av)``;
    ``final(carry) -> f``.  ``consts`` are host arrays (the fluid mask)
    that drivers pass to ``init`` as runtime arguments rather than let it
    embed them as HLO literals: a closure-embedded [ny, nx] mask makes
    the compiled module, and its cache key, grow with the grid.  ``init``
    also works without them (embedding), for tests and ad-hoc callers.
    """

    init: Callable[..., Any]
    step: Callable[[Any], tuple[Any, jax.Array]]
    final: Callable[[Any], jax.Array]
    consts: tuple = ()

    def single(self) -> Callable[[jax.Array], tuple[jax.Array, jax.Array]]:
        """Collapse to a plain ``f -> (f', av)`` one-step function (consts
        embedded — fine at the sizes this convenience path is used at)."""

        def fn(f: jax.Array) -> tuple[jax.Array, jax.Array]:
            carry, av = self.step(self.init(f))
            return self.final(carry), av

        return fn


def make_reference_program(
    params: LBMParams,
    obstacles: np.ndarray,
    free_cells_inv: np.float32,
) -> StepProgram:
    """The jnp step as a :class:`StepProgram`, with the fluid mask routed
    as a runtime operand (a carried scan leaf seeded from ``consts``)."""
    fluid_host = ~np.asarray(obstacles, dtype=bool)
    masked = make_masked_step_fn(params, free_cells_inv)

    def init(f, fluid=None):
        if fluid is None:
            fluid = jnp.asarray(fluid_host)
        return (f, fluid)

    def step(carry):
        f, fluid = carry
        f_new, av = masked(f, fluid)
        return (f_new, fluid), av

    return StepProgram(
        init=init,
        step=step,
        final=lambda carry: carry[0],
        consts=(fluid_host,),
    )
