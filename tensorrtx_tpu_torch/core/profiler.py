"""Profiling — the IProfiler / SimpleProfiler analog.

The port of the JAX package's `tensorrtx_tpu/core/profiler.py`.
Reference: tutorials/measure_performance.md:13-109 (per-layer ms table via
IProfiler::reportLayerTime) and vit/profiler.cc. `StageProfiler` gives the
per-stage wall-clock table for the host-visible pipeline stages (decode,
H2D, run, D2H, post); `trace()` wraps `torch.profiler` and writes a Chrome
trace; `device_p50_ms` and `queued_ms` read the card's own time of a call
from CUDA events.

Device times come from events around calls queued behind a GPU sleep, not
from the profiler: late in a long process `torch.profiler` can drop kernel
records from a window (whole launches missing, times too low), and events
cannot. Whatever is read from the profiler (`kernel_table`) comes with each
kernel's launch count, for the caller to check against what it launched.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["StageProfiler", "device_p50_ms", "kernel_table", "launches", "queued_ms", "trace"]


class StageProfiler:
    """Accumulates wall-clock per named stage; prints a SimpleProfiler-style
    aggregated table (count, total ms, mean ms)."""

    def __init__(self):
        self.times: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        """Times the block on the host's clock. A stage that ends in device
        work times it only if the block waits for that work (fetches a
        result or synchronizes)."""
        t0 = time.perf_counter()
        yield
        self.times[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float):
        self.times[name].append(seconds)

    def table(self) -> str:
        rows = [f"{'stage':<24}{'count':>7}{'total ms':>12}{'mean ms':>10}"]
        for name, ts in self.times.items():
            rows.append(f"{name:<24}{len(ts):>7}{sum(ts) * 1e3:>12.2f}"
                        f"{sum(ts) / len(ts) * 1e3:>10.3f}")
        return "\n".join(rows)

    def report(self):
        print(self.table())


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with `torch.profiler` (host ops, and the card's
    kernels and copies where there is a card) and write its Chrome trace to
    ``logdir/trace.json`` (the `--profile` flag analog). Yields the
    profiler, whose ``key_averages()`` sums the block by op and kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def kernel_table(fn: Callable[[], object], iters: int, expect: Optional[Dict[str, int]] = None,
                 windows: int = 3) -> Optional[List[Tuple[str, float, int]]]:
    """[(kernel or copy name, device ms over the window, launches)] of the
    card's work in ``iters`` calls of fn under `torch.profiler`, largest
    first, from the first of ``windows`` windows that recorded any device
    work and, with ``expect`` ({a part of a kernel's name: its launches in
    the window}), exactly those launches; None if no window did (the
    profiler drops records)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA), key=lambda r: -r[1])
        if rows and all(launches(rows, part) == n for part, n in (expect or {}).items()):
            return rows
    return None


def launches(rows: List[Tuple[str, float, int]], part: str) -> int:
    """The launches in a `kernel_table` of the kernels whose names hold part."""
    return sum(n for key, _, n in rows if part in key)


def _cycles_per_ms() -> float:
    """`torch.cuda._sleep` counts SM clock cycles: how many make a ms."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return 10_000_000 / start.elapsed_time(end)


def _queued_events(fn: Callable[[int], object], iters: int, each: bool) -> List[Tuple]:
    """(start, end) CUDA events around each of ``iters`` calls fn(i),
    enqueued while the stream waits behind a GPU sleep, so the card runs a
    call's launches back to back and the host's time between them stays
    hidden: one sleep before all the calls, or with ``each`` one before each
    call (the stream's queue holds some hundreds of launches, fewer than
    several eager forwards make). The sleep is sized from one warm call's
    host time; if a sleep has ended before its calls were all enqueued (the
    host was slower than guessed), the window is retried with longer
    sleeps. Raises if that never holds: fn waits for the device (a fetch, a
    synchronize, a pageable copy) or launches more than the queue holds."""
    if not torch.cuda.is_available():
        raise RuntimeError("device times need a CUDA device")
    t0 = time.perf_counter()
    fn(0)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    per_ms = _cycles_per_ms()
    sleep_ms = max(50.0, 3.0 * host_ms * (1 if each else iters))
    for _ in range(3):
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(iters)]
        queued = True
        for i, (start, end) in enumerate(events):
            if each or i == 0:
                torch.cuda._sleep(int(sleep_ms * per_ms))
                slept = torch.cuda.Event()
                slept.record()
            start.record()
            fn(i)
            end.record()
            if each or i == iters - 1:
                queued &= not slept.query()
        torch.cuda.synchronize()
        if queued:
            return events
        sleep_ms *= 4
    raise RuntimeError("the calls did not queue behind the GPU sleep: the function waits "
                       "for the device, or launches more than the stream's queue holds")


def queued_ms(fn: Callable[[], object], iters: int = 5) -> float:
    """Device ms per call of fn: CUDA events before the first and after the
    last of ``iters`` calls queued behind a GPU sleep, over ``iters``."""
    events = _queued_events(lambda i: fn(), iters, each=False)
    return events[0][0].elapsed_time(events[-1][1]) / iters


def device_p50_ms(fn: Callable, args_list: Sequence[tuple], iters: int = 20) -> float:
    """Median on-device time of one call ``fn(*args_list[i % len])``, from
    CUDA events around each of ``iters`` calls, each queued behind a GPU
    sleep of its own: what the card spends on one call when the host keeps
    it fed. For a CUDA graph replay that is the graph's one launch; for an
    eager call, its launches back to back. Raises without a CUDA device, or
    if fn waits for the device."""
    events = _queued_events(lambda i: fn(*args_list[i % len(args_list)]), iters, each=True)
    return float(np.median([s.elapsed_time(e) for s, e in events]))
