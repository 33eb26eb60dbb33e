"""Device-trace capture and aggregation — the framework's profiling
subsystem (SURVEY §5 "tracing/profiling"; the reference has only
commented-out `@profile` decorators and nvprof `-lineinfo` flags).

Host wall time says when the host got its answer; the profiler's device
events say what the GPU did meanwhile. Usage:

    from svox_t_tpu.utils.profiling import device_trace

    with device_trace("/tmp/my_trace") as t:
        out = my_jitted_fn(args)
        out.block_until_ready()      # the work must finish inside the trace
    t.summary(top=20)                # aggregated per-op device time
    t.busy_share                     # busy / window on the device

Only events on GPU device processes (``/device:GPU:N``) count; host
threads are ignored. A trace without a device process raises
``ValueError`` rather than reporting zero time. Kernel events are taken
from the device's stream threads when the trace has them (module- and
step-level threads span idle gaps and would double-count).
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
import shutil
from collections import defaultdict
from typing import Optional

_DEVICE_PROCESS = re.compile(r"^/device:GPU:\d+")
# Threads whose events span whole programs or steps, gaps included.
_SPAN_THREADS = ("Module", "Step")


def _union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


class TraceResult:
    """Aggregated GPU-side op times from a profiler trace directory."""

    def __init__(self, trace_dir: str):
        self.trace_dir = trace_dir
        self.by_name = {}
        self.counts = {}
        self.total_ms = 0.0
        self.busy_ms = 0.0
        self.window_ms = 0.0
        self.threads = []
        self._aggregate()

    @property
    def busy_share(self) -> float:
        """Device busy time over the device window (first op start to
        last op end)."""
        return self.busy_ms / self.window_ms if self.window_ms else 0.0

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_share

    def _aggregate(self):
        files = glob.glob(
            os.path.join(self.trace_dir, "**", "*.trace.json.gz"),
            recursive=True,
        )
        if not files:
            raise FileNotFoundError(f"no trace under {self.trace_dir}")
        f = max(files, key=os.path.getmtime)
        with gzip.open(f, "rt") as fh:
            events = json.load(fh).get("traceEvents", [])
        dev_pids = set()
        thread_names = {}
        for e in events:
            if e.get("ph") != "M":
                continue
            nm = e.get("args", {}).get("name", "")
            if e.get("name") == "process_name" and _DEVICE_PROCESS.match(nm):
                dev_pids.add(e["pid"])
            elif e.get("name") == "thread_name":
                thread_names[(e.get("pid"), e.get("tid"))] = nm
        if not dev_pids:
            raise ValueError(
                f"trace {f} has no GPU device process (/device:GPU:N); "
                "the traced work did not run on a GPU"
            )
        dev_threads = {
            k: v for k, v in thread_names.items() if k[0] in dev_pids
        }
        streams = {k for k, v in dev_threads.items() if v.startswith("Stream")}
        if streams:
            op_threads = streams
        else:
            op_threads = {
                k for k, v in dev_threads.items()
                if not any(s in v for s in _SPAN_THREADS)
            }
        self.threads = sorted({dev_threads[k] for k in op_threads})
        by = defaultdict(float)
        cnt = defaultdict(int)
        intervals = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            key = (e.get("pid"), e.get("tid"))
            if e.get("pid") not in dev_pids:
                continue
            # Threads without a name record still belong to the device.
            if key in thread_names and key not in op_threads:
                continue
            nm = e.get("name", "")
            by[nm] += e["dur"]
            cnt[nm] += 1
            intervals.append((e["ts"], e["ts"] + e["dur"]))
        self.by_name = dict(by)
        self.counts = dict(cnt)
        self.total_ms = sum(by.values()) / 1e3
        self.busy_ms = _union_us(intervals) / 1e3
        if intervals:
            self.window_ms = (
                max(e for _, e in intervals) - min(s for s, _ in intervals)
            ) / 1e3

    def top(self, n: int = 20):
        """[(name, total_ms, count)] sorted by total device time."""
        rows = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:n]
        return [(nm, dur / 1e3, self.counts[nm]) for nm, dur in rows]

    def summary(self, top: int = 20) -> str:
        lines = [
            f"device busy {self.busy_ms:.3f} ms of a {self.window_ms:.3f} ms "
            f"window (busy share {self.busy_share:.4f}); summed op time "
            f"{self.total_ms:.3f} ms"
        ]
        for nm, ms, c in self.top(top):
            lines.append(f"{ms:9.3f} ms  x{c:<6d} {nm[:100]}")
        out = "\n".join(lines)
        print(out)
        return out


class device_trace:
    """Context manager: captures a jax.profiler trace and aggregates the
    device-side events on exit (available as the `result` attribute /
    the value bound by ``with ... as t``)."""

    def __init__(self, trace_dir: str, clean: bool = True):
        self.trace_dir = trace_dir
        self.clean = clean
        self.result: Optional[TraceResult] = None

    def __enter__(self):
        import jax

        if self.clean and os.path.isdir(self.trace_dir):
            shutil.rmtree(self.trace_dir, ignore_errors=True)
        jax.profiler.start_trace(self.trace_dir)
        return self

    def __exit__(self, exc_type, exc, tb):
        import jax

        jax.profiler.stop_trace()
        if exc_type is None:
            self.result = TraceResult(self.trace_dir)
        return False

    # convenience passthroughs once the trace is closed
    @property
    def total_ms(self):
        return self.result.total_ms

    @property
    def busy_share(self):
        return self.result.busy_share

    def top(self, n: int = 20):
        return self.result.top(n)

    def summary(self, top: int = 20):
        return self.result.summary(top)
