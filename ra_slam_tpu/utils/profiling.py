"""Tracing / profiling utilities.

The reference instruments with manual wall-clock spans logged via
spdlog (`/root/reference/modules/tsdf_module.cc:108-112`,
`eval_one.cc:61-78`) and has no profiler integration (SURVEY.md §5.1).
Here: the same lightweight span accumulator, plus first-class
`jax.profiler` hooks (xprof traces, named scopes) — what you actually
use to find the hot op on the device.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import jax

# re-export: annotate device code so ops group in xprof
named_scope = jax.named_scope


class StageTimer:
    """Accumulates wall-clock spans per stage name.

    with timer.span("integrate"):        # host+dispatch time
        m, stats = step(...)
    with timer.span("integrate", block_on=m.tsdf):   # true device time
        m, stats = step(...)
    """

    def __init__(self):
        self.total_s: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                jax.block_until_ready(block_on)
            dt = time.perf_counter() - t0
            self.total_s[name] += dt
            self.count[name] += 1

    def mean_ms(self, name: str) -> float:
        n = self.count.get(name, 0)
        return 1e3 * self.total_s[name] / n if n else 0.0

    def summary(self) -> Dict[str, dict]:
        return {
            k: {
                "total_s": round(self.total_s[k], 4),
                "count": self.count[k],
                "mean_ms": round(self.mean_ms(k), 3),
            }
            for k in self.total_s
        }

    def report(self) -> str:
        lines = [
            f"{k:>20s}: {v['mean_ms']:8.2f} ms x {v['count']:<5d}"
            f" (total {v['total_s']:.2f} s)"
            for k, v in sorted(self.summary().items())
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """Capture an xprof trace of the enclosed block (no-op when
    log_dir is None). View with tensorboard / xprof."""
    if log_dir is None:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_info() -> dict:
    """The device a measurement ran on, as JAX reports it, plus the
    card's name and power limit from nvidia-smi (a card set below its
    maximum power runs slower under load)."""
    import subprocess

    d = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return {
        "platform": d.platform,
        "kind": d.device_kind,
        "count": len(jax.devices()),
        "nvidia_smi": smi[0] if smi else "",
    }
