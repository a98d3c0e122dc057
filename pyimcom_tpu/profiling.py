"""
Lightweight phase profiling for the coaddition pipeline.

The reference instruments per-solve stage timings with prints
(reference src/pyimcom/lakernel.py:320-323) and wraps destriping in
cProfile/memory profiling (reference src/pyimcom/imdestripe.py:2440-2457).
Here every hot phase of the block driver is bracketed with
:func:`phase` context managers; accumulated wall-clock per phase is
printed at the end of a block run when ``PYIMCOM_PROFILE=1``.

Device phases call ``block_until_ready`` on their results only when
profiling is enabled, so the async dispatch pipeline is unchanged in
production runs.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager

_ACC: dict[str, float] = defaultdict(float)
_CNT: dict[str, int] = defaultdict(int)


def enabled() -> bool:
    return os.environ.get("PYIMCOM_PROFILE", "0") == "1"


@contextmanager
def phase(name: str):
    """Accumulate wall time under `name` (no-op overhead when disabled)."""
    if not enabled():
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _ACC[name] += time.perf_counter() - t0
        _CNT[name] += 1


def sync(x):
    """Wait for the device to finish x when profiling, so phase times are
    honest; a no-op otherwise (the dispatch pipeline stays asynchronous)."""
    if enabled():
        import jax

        jax.block_until_ready(x)
    return x


def reset():
    _ACC.clear()
    _CNT.clear()


def report(header: str = "profile"):
    if not enabled() or not _ACC:
        return
    total = sum(_ACC.values())
    print(f"[{header}] phase timings (total bracketed {total:.2f} s):", flush=True)
    for name, t in sorted(_ACC.items(), key=lambda kv: -kv[1]):
        print(f"  {name:<28s} {t:9.3f} s  x{_CNT[name]}", flush=True)
