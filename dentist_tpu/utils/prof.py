"""Lightweight section profiler for hot-path attribution.

Enabled by ``DENTIST_TPU_PROF=1``; zero overhead otherwise (the context
manager short-circuits).  Sections accumulate wall seconds + hit counts
+ optional byte counts across threads; ``prof_report()`` dumps the table
to stderr.  Used to attribute stage wall-clock between device dispatch,
result fetch, and host passes — the reference has no analogue (its
stages are separate profiled binaries).

``trace_lines`` reduces a ``jax.profiler`` device trace to per-line
event counts and busy time (``scripts/trace_scan.py``).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from contextlib import contextmanager

ENABLED = bool(os.environ.get("DENTIST_TPU_PROF"))

_lock = threading.Lock()
_acc: dict[str, list] = {}  # name -> [seconds, hits, bytes]


@contextmanager
def prof(name: str, nbytes: int = 0):
    if not ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            a = _acc.setdefault(name, [0.0, 0, 0])
            a[0] += dt
            a[1] += 1
            a[2] += nbytes


def prof_add(name: str, seconds: float = 0.0, nbytes: int = 0, hits: int = 1):
    if not ENABLED:
        return
    with _lock:
        a = _acc.setdefault(name, [0.0, 0, 0])
        a[0] += seconds
        a[1] += hits
        a[2] += nbytes


def prof_report(reset: bool = True):
    if not ENABLED or not _acc:
        return
    with _lock:
        rows = sorted(_acc.items(), key=lambda kv: -kv[1][0])
        print("---- prof sections ----", file=sys.stderr)
        for name, (sec, hits, nb) in rows:
            mb = f" {nb/1e6:8.1f} MB" if nb else ""
            print(f"  {name:<40s} {sec:8.2f}s  x{hits:<6d}{mb}",
                  file=sys.stderr)
        if reset:
            _acc.clear()


def union_ns(spans) -> int:
    """Total length of the union of ``(start, end)`` intervals."""
    busy, end = 0, None
    for s, e in sorted(spans):
        if end is None or s >= end:
            busy, end = busy + e - s, e
        elif e > end:
            busy, end = busy + e - end, e
    return busy


def trace_lines(path: str, planes=("/device:GPU", "/host:CUDA")) -> list[dict]:
    """Reduce a ``jax.profiler`` trace (its ``.xplane.pb``): for each line
    of each plane whose name starts with one of ``planes``, the number of
    events, their summed duration, the union of their intervals (busy
    time), the span from first start to last end (all in ns), and the
    five commonest event names."""
    from collections import Counter

    from jax.profiler import ProfileData

    out = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith(tuple(planes)):
            continue
        for line in plane.lines:
            events = [(e.name, int(e.start_ns), int(e.duration_ns))
                      for e in line.events]
            spans = [(s, s + d) for _, s, d in events]
            out.append({
                "plane": plane.name, "line": line.name, "events": len(events),
                "sum_ns": sum(d for _, _, d in events),
                "busy_ns": union_ns(spans),
                "span_ns": (max(e for _, e in spans) - min(s for s, _ in spans)
                            if spans else 0),
                "top": Counter(n for n, _, _ in events).most_common(5),
            })
    return out
