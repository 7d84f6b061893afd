"""Per-frame timing decomposition (compute vs memory vs other).

Rebuilds the reference's measurement subsystem from ``clahevideo.cpp``:
separate series for pure-compute, memory/transfer, and total frame time
(``:37-44``), min/avg/max + percentage breakdown (``print_timing_stats``,
``:54-84``), a rolling window (default 200 frames, ``--timing-window``), a
per-N-frame report, and a final summary with FPS and efficiency percentages
(``:617-635``).

On the device the "compute" span is the jitted kernel (device execution,
measured with block_until_ready) and the "memory" span is host->device +
device->host transfer — the exact analogue of the reference's
CLAHE-vs-memcpy split.
"""

from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager

__all__ = ["TimingStats", "Span"]


class Span:
    """A monotonic stopwatch: ``with span: ...`` then ``span.ms``."""

    __slots__ = ("ms", "_t0")

    def __init__(self) -> None:
        self.ms = 0.0
        self._t0 = 0.0

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.ms = (time.perf_counter() - self._t0) * 1e3


def _nearest_rank(sorted_xs, pct: float) -> float:
    if not sorted_xs:
        return 0.0
    import math

    k = max(1, math.ceil(len(sorted_xs) * pct / 100.0))
    return sorted_xs[min(k, len(sorted_xs)) - 1]


def _stats(xs) -> tuple[float, float, float]:
    xs = list(xs)
    if not xs:
        return 0.0, 0.0, 0.0
    return sum(xs) / len(xs), min(xs), max(xs)


class TimingStats:
    """Rolling-window + lifetime timing accumulator."""

    def __init__(
        self,
        window: int = 200,
        detailed: bool = False,
        label: str = "",
        printer=print,
    ) -> None:
        self.window = window
        self.detailed = detailed
        self.label = label
        self.printer = printer
        self.compute_ms: deque[float] = deque(maxlen=window)
        self.memory_ms: deque[float] = deque(maxlen=window)
        self.total_ms: deque[float] = deque(maxlen=window)
        self.frame_count = 0
        self.sum_compute = 0.0
        self.sum_memory = 0.0
        self.sum_total = 0.0

    def record(self, compute_ms: float, memory_ms: float, total_ms: float) -> None:
        self.compute_ms.append(compute_ms)
        self.memory_ms.append(memory_ms)
        self.total_ms.append(total_ms)
        self.frame_count += 1
        self.sum_compute += compute_ms
        self.sum_memory += memory_ms
        self.sum_total += total_ms
        if self.detailed:
            self.printer(
                f"Frame {self.frame_count}: compute={compute_ms:.3f}ms "
                f"memory={memory_ms:.3f}ms total={total_ms:.3f}ms"
            )

    @contextmanager
    def frame(self):
        """Context measuring one frame; yields (compute_span, memory_span)."""
        c, m = Span(), Span()
        t0 = time.perf_counter()
        try:
            yield c, m
        finally:
            self.record(c.ms, m.ms, (time.perf_counter() - t0) * 1e3)

    @property
    def avg_total_ms(self) -> float:
        a, _, _ = _stats(self.total_ms)
        return a

    def percentile_total_ms(self, pct: float) -> float:
        """Rolling-window total-frame-time percentile (nearest-rank:
        the ceil(n*p/100)-th smallest value).

        The reference design is latency-first (leaky queues, drop rather
        than stall — SURVEY §7 hard parts): tail latency, not just the
        average, is the serving contract; p50/p95/p99 make it visible.
        """
        return _nearest_rank(sorted(self.total_ms), pct)

    def window_report(self) -> str:
        """The rolling-window block (clahevideo print_timing_stats format)."""
        ca, cmin, cmax = _stats(self.compute_ms)
        ma, mmin, mmax = _stats(self.memory_ms)
        fa, fmin, fmax = _stats(self.total_ms)
        fa_safe = fa if fa > 0 else 1e-9
        block = (
            f"\n=== TIMING ANALYSIS ({self.label}) ===\n"
            f"Compute Processing: avg={ca:.3f}ms, min={cmin:.3f}ms, "
            f"max={cmax:.3f}ms ({ca / fa_safe * 100:.1f}% of total)\n"
            f"Memory Operations: avg={ma:.3f}ms, min={mmin:.3f}ms, "
            f"max={mmax:.3f}ms ({ma / fa_safe * 100:.1f}% of total)\n"
            f"Total Frame Time: avg={fa:.3f}ms, min={fmin:.3f}ms, "
            f"max={fmax:.3f}ms ({(1000.0 / fa if fa > 0 else 0.0):.1f} FPS)\n"
            f"Processing Efficiency: Compute={ca / fa_safe * 100:.1f}%, "
            f"Memory={ma / fa_safe * 100:.1f}%, "
            f"Other={(fa - ca - ma) / fa_safe * 100:.1f}%\n"
            f"===============================================\n"
        )
        self.printer(block)
        return block

    def final_report(self) -> str:
        """Lifetime summary (clahevideo.cpp:617-635 format)."""
        n = max(self.frame_count, 1)
        ac = self.sum_compute / n
        am = self.sum_memory / n
        at = self.sum_total / n
        at_safe = at if at > 0 else 1e-9
        win = sorted(self.total_ms)  # one sort for all three percentiles
        block = (
            f"\n=== FINAL PERFORMANCE ANALYSIS ===\n"
            f"Configuration: {self.label}\n"
            f"Total frames processed: {self.frame_count}\n"
            f"Average timings per frame:\n"
            f"  Compute processing: {ac:.3f} ms ({ac / at_safe * 100:.1f}%)\n"
            f"  Memory operations: {am:.3f} ms ({am / at_safe * 100:.1f}%)\n"
            f"  Other operations: {at - ac - am:.3f} ms "
            f"({(at - ac - am) / at_safe * 100:.1f}%)\n"
            f"  Total frame time: {at:.3f} ms "
            f"({(1000.0 / at if at > 0 else 0.0):.1f} FPS)\n"
            f"Latency (last {len(self.total_ms)} frames): "
            f"p50={_nearest_rank(win, 50):.3f} ms, "
            f"p95={_nearest_rank(win, 95):.3f} ms, "
            f"p99={_nearest_rank(win, 99):.3f} ms\n"
            f"Performance efficiency: compute is {ac / at_safe * 100:.1f}% "
            f"of total processing time\n"
            f"===================================\n"
        )
        self.printer(block)
        return block
