"""Profiling & perf accounting (reference aux subsystem 1, SURVEY §5.1).

The reference's CPU era used TAU per-function profiles; its GPU era used
wall-clock + derived GB/s in the report.  The equivalents here:

* :func:`trace` — context manager around ``jax.profiler`` producing a
  TensorBoard-loadable trace of the compiled step program.
* :class:`PerfReport` — MLUPS and effective-memory-bandwidth accounting from
  a run (the GB/s figures the reference report derives by hand).
"""

from __future__ import annotations

import contextlib
import dataclasses

import jax

# Bytes touched per cell per step by a single-pass step: read 9 f-planes
# + 1 mask plane, write 9 f-planes, float32.
BYTES_PER_CELL = (9 + 1 + 9) * 4
FLOPS_PER_CELL = 140  # approximate arithmetic op count of the step


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("/tmp/lbm_trace"): sim.run()`` -> TensorBoard trace."""
    with jax.profiler.trace(log_dir):
        yield


@dataclasses.dataclass(frozen=True)
class PerfReport:
    """Derived performance figures for one run."""

    nx: int
    ny: int
    steps: int
    elapsed: float

    @property
    def cell_updates(self) -> int:
        return self.nx * self.ny * self.steps

    def _rate(self, quantity: float) -> float:
        # A zero-step run (max_iters=0 is valid) or sub-timer-resolution
        # elapsed must not crash a report; same convention as
        # diagnostics.ResultMetrics.mlups: rate -> inf when elapsed is 0,
        # not an exception and not a spurious 0 (a 0 would make a
        # faster-than-the-timer run read as "no throughput").
        if self.elapsed > 0.0:
            return quantity / self.elapsed
        return float("inf")

    @property
    def mlups(self) -> float:
        return self._rate(self.cell_updates) / 1e6

    @property
    def effective_bandwidth_gbs(self) -> float:
        """Nominal device-memory bytes/s of a single-pass step."""
        return self._rate(self.cell_updates * BYTES_PER_CELL) / 1e9

    @property
    def effective_gflops(self) -> float:
        return self._rate(self.cell_updates * FLOPS_PER_CELL) / 1e9

    def summary(self) -> str:
        return (
            f"{self.nx}x{self.ny} x {self.steps} steps in {self.elapsed:.3f}s: "
            f"{self.mlups:.0f} MLUPS, {self.effective_bandwidth_gbs:.0f} GB/s "
            f"effective, {self.effective_gflops:.0f} GFLOP/s"
        )


NVIDIA_SMI_QUERY = [
    "nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
]


def parse_nvidia_smi(text: str) -> list[tuple[str, str]]:
    """``name, power.limit`` CSV lines (one per card) -> [(name, limit)]."""
    cards = []
    for line in text.strip().splitlines():
        name, sep, limit = line.rpartition(",")
        if not sep:
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        cards.append((name.strip(), limit.strip()))
    return cards


def device_report() -> dict:
    """What a measurement ran on: JAX's platform, device kind and device
    count, plus each card's name and power limit from ``nvidia-smi`` on a
    GPU (a card may be set below its maximum power and then runs slower
    under load, so every number is kept beside its limit)."""
    import subprocess

    devs = jax.devices()
    report = {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }
    if report["platform"] == "gpu":
        out = subprocess.run(
            NVIDIA_SMI_QUERY, capture_output=True, text=True, check=True
        ).stdout
        report["cards"] = [
            {"name": n, "power_limit": p} for n, p in parse_nvidia_smi(out)
        ]
    return report
