"""Device traces (port of nerf_simple_tpu/utils/profiling.py's
``trace_context``; its throughput meter and chunk walk live in
train/loop.py).

``trace_context(log_dir)`` records what runs inside it with
``torch.profiler`` (CPU and, on a card, CUDA activities) and writes one
Chrome trace, ``<log_dir>/trace_<pid>_<ns>.json``, readable in Perfetto or
``chrome://tracing`` (the card's machine has no TensorBoard).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace_context(log_dir: str | None):
    """A ``torch.profiler`` trace of the block into ``log_dir``; a no-op
    when ``log_dir`` is empty or None. Yields the profiler (None when off);
    the trace's path is its ``trace_path`` after the block."""
    if not log_dir:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.trace_path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)
