"""Profiling & phase timing.

The reference's only observability is a nanosecond wall-clock timer feeding
ETA prints (reference: src/MyTimer.h:20-86, src/Bayes.cpp:884-914).  Here
the equivalent story is (a) per-phase wall timing with derived throughput and
(b) real device traces via ``jax.profiler`` viewable in TensorBoard/Perfetto.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class PhaseTimer:
    """Accumulates named phase durations; prints a compact report.

    >>> t = PhaseTimer()
    >>> with t.phase("ingest"): ...
    >>> with t.phase("mcmc"): ...
    >>> t.report()
    """

    phases: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def total(self) -> float:
        return sum(self.phases.values())

    def report(self, *, items: dict | None = None, out=print):
        """items: optional {phase: count} to derive a rate column."""
        tot = self.total() or 1e-12
        out(f"{'phase':<16}{'seconds':>10}{'share':>8}{'rate':>14}")
        for name, sec in self.phases.items():
            rate = ""
            if items and name in items and sec > 0:
                rate = f"{items[name] / sec:,.0f}/s"
            out(f"{name:<16}{sec:>10.3f}{sec / tot:>7.1%}{rate:>14}")


@contextlib.contextmanager
def device_trace(logdir: str | None):
    """jax.profiler trace scope; no-op when logdir is None.

    Wrap a fit call to capture an XLA device trace:

    >>> with device_trace("/tmp/tb"):
    ...     ibrm(...)

    then inspect with TensorBoard's profile plugin or Perfetto.
    """
    if logdir is None:
        yield
        return
    import jax

    with jax.profiler.trace(str(logdir)):
        yield


def annotate(name: str):
    """Named TraceAnnotation scope so a phase shows up inside device traces."""
    import jax

    return jax.profiler.TraceAnnotation(name)
