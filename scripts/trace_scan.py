"""Profile one warmed call of the packed extension scan on the GPU at each
lane width of ``aligner._LANE_BUCKETS`` (R=32,256, W=256) and reduce the
trace.

    python scripts/trace_scan.py [OUT_JSON]

For each width it prints the call's host-clock time without and with the
profiler, and, for each line of the GPU's trace planes, the number of
events, events per DP row, the device busy time (union of the events'
intervals) and its share of the traced call.  The full reduction, with
the commonest event names per line, goes to ``OUT_JSON`` if given.  Runs
only on a GPU, on one card.
"""

from __future__ import annotations

import glob
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402


def trace_widths(device, R: int, widths, planes=("/device:GPU", "/host:CUDA"),
                 out=print) -> list[dict]:
    """Trace the packed extension scan at ``R`` rows for each lane count
    in ``widths`` (multiples of the first) on ``device``."""
    import jax

    from dentist_tpu.utils.prof import trace_lines

    rng = np.random.default_rng(0)
    case = chip_smoke._extension_cases(rng, chip_smoke._HostArena(1 << 25),
                                       R=R, N=widths[0])[0]
    runs = []
    for N in widths:
        name, fn, args = chip_smoke.widen_packed(case, N // widths[0])
        dargs = [jax.device_put(a, device) for a in args]
        _, _, warm = chip_smoke._timed(fn, dargs)
        with tempfile.TemporaryDirectory() as d:
            with jax.profiler.trace(d):
                t0 = time.perf_counter()
                fn(*dargs).block_until_ready()
                traced = time.perf_counter() - t0
            (path,) = glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                                recursive=True)
            lines = trace_lines(path, planes)
        runs.append({"name": name, "N": N, "R": R, "warm_s": warm,
                     "traced_s": traced, "lines": lines})
        out(f"{name}: warmed call {warm * 1e3:.3f} ms, traced call "
            f"{traced * 1e3:.3f} ms on {device.device_kind}")
        for ln in lines:
            if ln["events"]:
                out(f"  {ln['plane']} / {ln['line']}: {ln['events']} events "
                    f"({ln['events'] / R:.2f} per row), busy "
                    f"{ln['busy_ns'] / 1e6:.3f} ms = "
                    f"{ln['busy_ns'] / 1e9 / traced:.3f} of the traced call")
    return runs


def main(argv) -> int:
    chip_smoke._restrict_cards(1)
    import jax

    from dentist_tpu.ops.aligner import _BUCKETS, _LANE_BUCKETS
    from dentist_tpu.utils.device import (describe, nvidia_smi_name_power,
                                          require_gpu)

    gpu = require_gpu(jax.devices())
    report = {"device": describe(jax.devices()), "card": nvidia_smi_name_power()}
    print(f"device: {report['device']}; card (name, power.limit): "
          f"{report['card']}", flush=True)
    report["runs"] = trace_widths(gpu, _BUCKETS[-1], _LANE_BUCKETS,
                                  out=lambda s: print(s, flush=True))
    if argv:
        os.makedirs(os.path.dirname(os.path.abspath(argv[0])), exist_ok=True)
        with open(argv[0], "w") as fh:
            json.dump(report, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
