"""Tracing / profiling / observability (SURVEY §5).

The reference's observability is ``time.process_time()`` prints scattered in
demo mains; here it is a small structured harness:

- ``Timer``: wall-clock bracketing with audio-seconds/s accounting;
- ``benchmark``: compile-then-measure of any jitted fn, synchronised with
  ``block_until_ready``;
- ``trace``: context manager around ``jax.profiler`` for on-device traces;
- ``stage_metrics``: per-stage metric dicts (SNR gain, gains, presence
  heatmaps) matching the reference's habit of returning debug taps.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import jax


@dataclass
class Timer:
    name: str = "stage"
    audio_seconds: float = 0.0
    elapsed: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed += time.perf_counter() - self._t0

    @property
    def realtime_factor(self) -> float:
        return self.audio_seconds / self.elapsed if self.elapsed else float("inf")


class TimingError(RuntimeError):
    """A throughput measurement could not be made trustworthy."""


def slope_per_iter(
    run: Callable[[int], float],
    pairs=((1, 4), (2, 6), (3, 8)),
    retries: int = 2,
    min_per_iter: float = 0.0,
    log: Optional[Callable[[str], None]] = None,
) -> tuple:
    """Robust slope timing: per-iteration cost as the median slope over
    several iteration pairs.

    ``run(n)`` must execute ``n`` iterations and wait for the device
    (``block_until_ready``).  The slope ``(run(n2) - run(n1)) / (n2 - n1)`` cancels the
    fixed dispatch+fetch overhead.

    Unlike a bare two-point slope, this harness CANNOT silently emit
    garbage: any non-positive or non-finite slope, or a median below
    ``min_per_iter`` (the physical sanity floor — an implied throughput
    above the hardware roofline), restarts the whole measurement; after
    ``retries`` restarts it raises ``TimingError``.  (A bare two-point slope
    once clamped a negative slope to 1e-9 s and printed a physically
    impossible rate; this utility exists so that cannot happen again.)

    Returns ``(per_iter_seconds, n_retries)``.
    """
    if len(pairs) < 3:
        raise ValueError(f"need >= 3 iteration pairs for a robust median, got {len(pairs)}")
    last = None
    for attempt in range(retries + 1):
        slopes = []
        for n1, n2 in pairs:
            t1, t2 = run(n1), run(n2)
            slopes.append((t2 - t1) / (n2 - n1))
        per = float(np.median(slopes))
        ok = all(np.isfinite(s) and s > 0.0 for s in slopes) and per >= min_per_iter
        if ok:
            return per, attempt
        last = slopes
        if log is not None:
            log(f"slope_per_iter retry {attempt + 1}/{retries}: slopes={['%.3g' % s for s in slopes]}")
    raise TimingError(
        f"unreliable timing after {retries + 1} attempts: slopes={last} "
        f"(min_per_iter={min_per_iter:.3g}s); refusing to report a throughput"
    )


def benchmark(fn: Callable, *args, iters: int = 8, warmup: int = 2) -> Dict[str, float]:
    """Measure a jitted fn with robust slope timing (``block_until_ready``).

    Returns {'per_call_s', 'calls_per_s', 'retries'}.
    """
    for _ in range(warmup):
        out = fn(*args)
        _sync(out)

    def run(n):
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn(*args)
        _sync(out)
        return time.perf_counter() - t0

    base = max(1, iters // 4)
    pairs = ((base, iters), (base + 1, iters + base), (base + 2, iters + 2 * base))
    per, retries = slope_per_iter(run, pairs=pairs)
    return {"per_call_s": per, "calls_per_s": 1.0 / per, "retries": float(retries)}


def _sync(out: Any) -> None:
    jax.block_until_ready(out)


@contextlib.contextmanager
def trace(logdir: str = "jax-trace"):
    """jax.profiler trace around a block; view with xprof/tensorboard."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def stage_metrics(name: str, signal_in: np.ndarray, signal_out: np.ndarray, p: Optional[np.ndarray] = None) -> Dict:
    """Structured per-stage report: energies, crude SNR-gain proxy, SPP stats."""
    ein = float(np.mean(np.square(signal_in)))
    eout = float(np.mean(np.square(signal_out)))
    m: Dict[str, Any] = {
        "stage": name,
        "energy_in": ein,
        "energy_out": eout,
        "energy_ratio_db": 10.0 * np.log10(eout / ein) if ein > 0 else float("-inf"),
    }
    if p is not None:
        m["p_mean"] = float(np.mean(p))
        m["p_active_frac"] = float(np.mean(p > 0.5))
    return m
