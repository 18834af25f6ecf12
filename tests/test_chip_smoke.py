"""``chip_smoke.py`` and the GPU-only measurement rules, checked on the CPU.

The smoke run itself needs a GPU; here its parts run at tiny shapes: the
device check refuses a CPU backend, the kernel-compare harness runs
CPU-vs-CPU, the log scan flags every fallback event, and the
compile-cache rule honours ``JAX_COMPILATION_CACHE_DIR``.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from dentist_tpu.sim.example import reference_example  # noqa: E402
from dentist_tpu.utils import cache  # noqa: E402
from dentist_tpu.utils.prof import trace_lines, union_ns  # noqa: E402
from dentist_tpu.utils.device import describe, require_gpu  # noqa: E402


# ---- compile cache -------------------------------------------------------


def test_compile_cache_dir_rule():
    assert cache.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x"}) is None
    path = cache.compile_cache_dir({})
    assert path == os.path.join(REPO, ".jax_cache")


@pytest.mark.parametrize("env_dir", [None, "/somewhere/else"])
def test_enable_compile_cache_sets_dir_only_without_env(monkeypatch, env_dir):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    cache.enable_compile_cache()
    if env_dir is None:
        assert calls["jax_compilation_cache_dir"] == cache.CHECKOUT_CACHE_DIR
    else:
        assert "jax_compilation_cache_dir" not in calls
    assert calls["jax_persistent_cache_min_compile_time_secs"] == 0.0


def test_checkout_cache_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


# ---- device check ----------------------------------------------------------


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit) as exc:
        require_gpu(jax.devices())
    assert exc.value.code not in (0, None)
    assert describe(jax.devices())["platform"] == "cpu"


#: why the script refuses to run: in the checkout on a CPU-only backend,
#: the device check; alone in a directory, the missing program
_REFUSAL = {"checkout": "no GPU: JAX's first device is on platform 'cpu'",
            "alone": "No module named 'dentist_tpu'"}


@pytest.mark.parametrize("where", sorted(_REFUSAL))
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    """No GPU (or no repository beside it): non-zero exit, no result line,
    and the refusal names its cause."""
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(script), "--mb", "1"],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert _REFUSAL[where] in proc.stderr, proc.stderr[-2000:]
    assert "kernel " not in proc.stdout  # refused before any phase ran


# ---- kernel-compare harness ------------------------------------------------


@pytest.fixture(scope="module")
def small_comparison():
    cases, arena = chip_smoke.kernel_cases(arena_capacity=1 << 23, small=True)
    cpu0, cpu1 = jax.devices()[:2]
    results = chip_smoke.compare_kernels(cases, arena, cpu0, cpu1,
                                         out=lambda s: None)
    return cases, results


def test_kernel_cases_cover_every_family(small_comparison):
    cases, _ = small_comparison
    families = {name.split()[0] for name, _, _ in cases}
    assert families == {
        "_extend_scan_v3_packed", "_extend_scan_v3_resident",
        "_nw_round_packed_sparse", "_nw_window_round_sparse",
        "_nw_window_round_resident", "_nw_dist_pair_packed",
        "_arena_write_chunk"}
    bound = [name for name, _, _ in cases if "bound_diag=True" in name]
    assert len(bound) == 2  # packed and resident, with diagonal bounds


def test_kernel_compare_cpu_vs_cpu_is_bit_identical(small_comparison):
    _, results = small_comparison
    for r in results:
        assert r["bit_identical"], r["name"]
        assert r["warm_s"] > 0 and r["shape"]


def test_kernel_compare_flags_a_difference():
    """A kernel whose result depends on the device must be flagged."""
    def by_device(x):
        return x + next(iter(x.devices())).id

    cpu0, cpu1 = jax.devices()[:2]
    (r,) = chip_smoke.compare_kernels(
        [("by_device", by_device, (np.zeros(4, np.int32),))],
        np.zeros(8, np.uint8), cpu0, cpu1, out=lambda s: None)
    assert not r["bit_identical"]


def test_widened_extension_repeats_narrow_result(small_comparison):
    """The production-width check: lanes repeated, result repeated."""
    cases, _ = small_comparison
    name, fn, (chars, meta) = cases[0]
    wname, wfn, (wchars, wmeta) = chip_smoke.widen_packed(cases[0], 3)
    N = chars.shape[0]
    assert wname == name.replace(f" N={N} ", f" N={3 * N} ")
    assert wchars.shape == (3 * N, chars.shape[1])
    assert wmeta.shape == (meta.shape[0] + 2 * 5 * N,)  # 5 per-lane rows
    r = chip_smoke.check_widened(cases[0], 3, jax.devices()[0],
                                 out=lambda s: None)
    assert r["bit_identical"] and r["shape"][1] == 3 * N


def test_extension_case_lanes_align(small_comparison):
    """The packed extension inputs are real alignments, not noise: most
    lanes extend to the end of the window."""
    cases, _ = small_comparison
    name, fn, args = cases[0]
    assert name.startswith("_extend_scan_v3_packed")
    best_r = np.asarray(fn(*args))[0]
    R = int(name.split("R=")[1].split()[0])
    assert (best_r > 0.9 * R).mean() > 0.5


# ---- fallback events ---------------------------------------------------------


@pytest.mark.parametrize("event", sorted(chip_smoke.FALLBACK_EVENTS))
def test_fallback_event_is_flagged(event):
    lines = [
        json.dumps({"logLevel": "info", "event": "pipelineDone"}),
        '{"truncated": ',  # a line cut by a concurrent writer
        json.dumps({"logLevel": "warn", "event": event, "error": "x"}),
    ]
    found = chip_smoke.fallback_events(lines)
    assert [r["event"] for r in found] == [event]


def test_clean_log_has_no_fallback():
    lines = [json.dumps({"event": e}) for e in
             ("alignStorePair", "processPileUps", "pileUpSkipped")]
    assert chip_smoke.fallback_events(lines) == []


def test_scenario_scales_the_reference_example():
    g, records, contigs, structure, reads, store = reference_example(0.3)
    assert len(g) >= 300_000
    assert len(structure.gaps) == round(147 * 0.3 / 28)
    assert len(reads) == len(store.lengths) > 0


# ---- trace reduction ----------------------------------------------------------


@pytest.mark.parametrize("spans, busy", [
    ([], 0),
    ([(0, 10), (20, 25)], 15),  # disjoint
    ([(0, 10), (5, 12), (2, 4)], 12),  # overlapping and nested
    ([(20, 30), (0, 20)], 30),  # touching, out of order
])
def test_union_ns(spans, busy):
    assert union_ns(spans) == busy


def test_trace_lines_reduces_a_cpu_trace(tmp_path):
    """The reduction reads a real ``jax.profiler`` trace (the CPU's host
    planes stand in for the GPU's)."""
    import glob

    f = jax.jit(lambda x: jax.lax.scan(lambda c, _: (c * 2 + 1, None), x,
                                       None, length=64)[0])
    x = jax.numpy.ones(256, jax.numpy.int32)
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        f(x).block_until_ready()
    (path,) = glob.glob(str(tmp_path / "**" / "*.xplane.pb"), recursive=True)
    assert trace_lines(path) == []  # no GPU plane on this machine
    lines = trace_lines(path, planes=("/host:CPU",))
    assert sum(ln["events"] for ln in lines) > 0
    for ln in lines:
        assert 0 <= ln["busy_ns"] <= min(ln["sum_ns"], ln["span_ns"])
        assert sum(c for _, c in ln["top"]) <= ln["events"]


# ---- on the card --------------------------------------------------------------


@pytest.mark.gpu
def test_small_kernels_bit_identical_on_gpu(gpu_env):
    code = (
        "import sys, jax, chip_smoke\n"
        "cases, arena = chip_smoke.kernel_cases(1 << 23, small=True)\n"
        "res = chip_smoke.compare_kernels(cases, arena, jax.devices()[0],\n"
        "                                 jax.devices('cpu')[0])\n"
        "sys.exit(0 if all(r['bit_identical'] for r in res) else 1)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=gpu_env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + proc.stderr
