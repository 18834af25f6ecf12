"""Background compile warmers: a failing task is logged, never swallowed.

``warm_shapes`` (consensus) and ``Aligner._warm_resident`` (extension)
compile programs from daemon threads and must not stop the run when a
compile fails — but a silent failure would hide a fault on the card, so
each one is logged as a ``warmFailed`` event (which ``chip_smoke.py``
refuses).
"""

import threading
from types import SimpleNamespace

import jax
import numpy as np

import dentist_tpu.ops.aligner as A
import dentist_tpu.ops.banded as B
import dentist_tpu.ops.consensus as C


def _refuse(*args, **kwargs):
    raise RuntimeError("compile refused")


def _join(name: str):
    for t in threading.enumerate():
        if t.name == name:
            t.join(timeout=120)
            assert not t.is_alive(), f"{name} did not finish"


def test_warm_shapes_logs_each_failed_task(monkeypatch):
    events = []
    monkeypatch.setattr(C, "log_json", lambda level, **kw: events.append(kw))
    monkeypatch.setattr(C, "_is_accel", lambda: True)
    monkeypatch.setattr(C, "_WARM_STARTED", False)
    monkeypatch.setattr(B, "_arena_capacity", lambda: 1 << 20)
    monkeypatch.setattr(B, "ARENA", B._Arena())
    for kernel in ("_nw_round_packed_sparse", "_nw_window_round_resident",
                   "_nw_window_round_sparse", "_nw_dist_pair_packed"):
        monkeypatch.setattr(C, kernel, _refuse)
    C.warm_shapes(max_workers=2)
    _join("dentist-warm-cons")
    n_tasks = 1 + 2 * len(C._T_BUCKETS) + 2 * len(C._N_BUCKETS)
    assert len(events) == n_tasks
    assert all(e["event"] == "warmFailed" and "compile refused" in e["error"]
               for e in events)
    assert {e["task"] for e in events} == {"_windowed", "_full", "_gains"}


def test_warm_resident_logs_a_failed_compile(monkeypatch):
    events = []
    monkeypatch.setattr(A, "log_json", lambda level, **kw: events.append(kw))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(B, "extend_batch_resident_async", _refuse)
    monkeypatch.setattr(A.Aligner, "_RES_WARMED", set())
    A.Aligner._warm_resident(SimpleNamespace(_KMAX=8), np.zeros(16, np.uint8),
                             256)
    _join("dentist-warm-resident")
    assert [e["event"] for e in events] == ["warmFailed"]
    assert "compile refused" in events[0]["error"]
