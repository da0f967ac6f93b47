"""Device time of work on the card, read from a ``torch.profiler`` trace.

CUDA events around one call measure the host as well when the call
launches small kernels from Python: the card idles while the host
prepares the next launch.  The kernels' own durations in a profiler
trace do not.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, List, Optional, Tuple


def kernel_events(prof) -> List[Tuple[str, float, float]]:
    """(name, start_us, duration_us) of every kernel the card ran while
    ``prof`` (a finished ``torch.profiler.profile``) was recording."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
    return [(e["name"], e["ts"], e["dur"]) for e in trace.get("traceEvents", [])
            if e.get("cat") == "kernel" and "dur" in e]


def busy_us(events: List[Tuple[str, float, float]]) -> float:
    """Length of the union of the kernels' intervals."""
    total, end = 0.0, float("-inf")
    for _, start, dur in sorted(events, key=lambda e: e[1]):
        stop = start + dur
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def device_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 3,
              kernel: Optional[str] = None) -> float:
    """Device time of one call of ``fn`` in ms: the summed durations of
    the kernels that ``iters`` calls ran (only those whose name contains
    ``kernel``, when given), over ``iters``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(dur for name, _, dur in kernel_events(prof)
               if kernel is None or kernel in name) / iters / 1e3
