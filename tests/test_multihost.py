"""Multi-host execution: 2 ``jax.distributed`` processes, one 8-device mesh.

BASELINE.md demands scaling evidence at "1 chip / 1 host / ≥ 2 hosts";
this validates the ≥2-host axis the way the driver validates multi-chip:
two REAL processes (4 virtual CPU devices each) join a cluster through
``dentist_tpu.parallel.dp.init_distributed`` — the same entry point a
multi-host GPU cluster uses — and run the production mapper + consensus sharded over
the global mesh, asserting bit-equality with single-device results in
each process (see ``_multihost_worker.py``).
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(__file__), "_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_distributed_mapper_and_consensus():
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen([sys.executable, _WORKER, str(pid), port],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, env=env)
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert f"MULTIHOST_OK pid={pid} procs=2 devices=8" in out, out[-4000:]
