"""Frame timing: host wall clock around work that ends in block_until_ready.

JAX dispatches asynchronously, so a time taken without block_until_ready
measures the enqueue, not the frame. The one protocol every timing consumer
(bench.py, chip_smoke.py, tools/frametime.py, tools/profile_frame.py)
shares: compile and run one frame first (set-up, not timed), then time each
frame on its own, from dispatch to ready. Renderers must take data as
traced arguments (nullary jitted closures constant-fold).
"""

from __future__ import annotations

import time


def frame_times_ms(render, *args, frames: int = 50):
    """Per-frame wall times (ms) of `render(*args)`, unsorted. Returns
    (times, compile_s, first_out): compile_s is the first call's wall time
    (trace + compile + one frame), reported as set-up."""
    from jax import block_until_ready

    t0 = time.perf_counter()
    out = block_until_ready(render(*args))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        block_until_ready(render(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return times, compile_s, out


def percentile(vals, q: float) -> float:
    """Linear-interpolated percentile (q in [0, 100]) of a list of values."""
    s = sorted(vals)
    pos = (len(s) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)
