"""Numerical debugging aids (reference aux subsystem 2, SURVEY §5.2).

The reference had a commented-out ``feenableexcept`` FP trap and relied on
double-buffering for race freedom.  JAX's purity makes the aliasing race
impossible by construction; what remains useful:

* :func:`nan_guard` — opt-in ``jax.debug_nans`` scope (the FP-trap analog).
* :func:`assert_mass_conserved` — the ``total_density`` invariant as an
  assertion helper for tests and long-run monitoring.
"""

from __future__ import annotations

import contextlib

import jax
import numpy as np

from lbm_tpu.diagnostics import total_density


@contextlib.contextmanager
def nan_guard():
    """Raise on NaN production inside the scope (FP-trap analog)."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def assert_mass_conserved(
    f_before: np.ndarray, f_after: np.ndarray, rtol: float = 1e-5
) -> None:
    """Total density must be invariant across steps (body force excluded:
    the accelerate kick adds and removes equal mass, so it holds there too).
    """
    m0 = total_density(f_before)
    m1 = total_density(f_after)
    if not np.isfinite(m1) or abs(m1 - m0) > rtol * abs(m0):
        raise AssertionError(
            f"mass not conserved: {m0!r} -> {m1!r} (rtol {rtol})"
        )
