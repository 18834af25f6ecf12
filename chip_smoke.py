"""Smoke run of dentist-tpu on an NVIDIA GPU: every device kernel, and the
whole ``close_gaps`` path at the reference example's scale.

    python chip_smoke.py            # one card: device, kernels, pipeline
    python chip_smoke.py --mb 1     # the same at a 1 Mb rehearsal scale
    python chip_smoke.py --four     # only the four-card mesh phase

Phases, in order, in one process (one JAX process per card):

device    refuse any backend but a GPU; name the card and its power
          limit; rebuild the native library from the tracked sources
          and load it.
kernels   each device kernel family at production widths, run on the GPU
          and on the CPU backend of this same process.  All arithmetic is
          int32/uint8 with no matrix product, so the results must be
          bit-identical.  Prints one warmed call's device time per kernel
          (host clock around ``block_until_ready``).  The packed extension
          scan also runs at the production lane width (1,024 lanes, its
          128 lanes repeated), on the GPU only, and must return the
          128-lane result repeated.
pipeline  the reference example's scale (28 Mb, 147 gaps of 100-1,000 bp,
          4 x 28 interspersed 3 kb repeats, 20x reads at 25 +- 12.5 kb
          with 13 % error; ``sim.example.reference_example``) written as
          FASTA and run through ``dentist_tpu.cli.main(["pipeline", ...])``
          with ``DENTIST_TPU_STRICT=1``, then scored against the truth
          with ``eval.check_results``.  Fails unless every gap closes.
--four    ``close_gaps`` on the four-card ``dp`` mesh and again with
          ``DENTIST_TPU_FORCE_SINGLE=1`` in the same process; the FASTA,
          AGP and BED must be byte-equal.  Runs no other phase.

Any fallback event in the run's log (a failed consensus batch, a failed
warm task, an arena fallback, a native build/load failure) fails the run.
The last line of stdout is one JSON object, printed only when every phase
passed: ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count":
...}}``.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

#: events that mean the run took a fallback path; any of them fails the run
FALLBACK_EVENTS = frozenset({
    "consensusBatchFailed", "warmFailed", "arenaFallback",
    "nativeBuildFailed", "nativeLoadFailed", "nativeSymbolMissing",
})


def fallback_events(log_lines) -> list[dict]:
    """The records of ``log_lines`` (JSON lines) that name a fallback."""
    found = []
    for line in log_lines:
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # a line cut by a concurrent writer
        if isinstance(rec, dict) and rec.get("event") in FALLBACK_EVENTS:
            found.append(rec)
    return found


# ----------------------------------------------------------------------
# kernels: production-width inputs for each device kernel family


def _aligned(rng, length: int, error: float = 0.13):
    """A random sequence and a copy with CLR-like errors (lanes that align)."""
    from dentist_tpu.sim.reads import _mutate

    a = rng.integers(0, 4, length).astype(np.uint8)
    return a, _mutate(a, rng, error)


class _HostArena:
    """A host image of the device arena, filled region by region."""

    def __init__(self, capacity: int):
        from dentist_tpu.ops.banded import RESIDENT_PAD

        self.array = np.zeros(capacity, np.uint8)
        self.pos = RESIDENT_PAD

    def put(self, codes) -> int:
        off = self.pos
        self.array[off : off + len(codes)] = codes
        self.pos += len(codes) + 64
        return off


def _extension_cases(rng, arena: _HostArena, R: int, N: int, W: int = 256):
    from dentist_tpu.ops.banded import (DIAG_UNBOUNDED, _extend_scan_v3_packed,
                                        _extend_scan_v3_resident, _pack2bit,
                                        bw_for)

    K = 8
    BW = bw_for(R, W)
    num_k = np.array([int(R * (0.96 + 0.01 * k)) for k in range(K)], np.int32)
    lane_k = (np.arange(N) % K).astype(np.int32)
    a_win = np.zeros((N, R), np.uint8)
    b_win = np.zeros((N, BW), np.uint8)
    b_len = np.zeros(N, np.int32)
    meta12 = np.zeros((12, N), np.int32)
    for n in range(N):
        a, b = _aligned(rng, R)
        b = b[: BW - W]
        a_win[n] = a
        b_win[n, W : W + len(b)] = b
        b_len[n] = min(len(b), int(num_k[lane_k[n]]) + W // 2)
        a_off, b_off = arena.put(a), arena.put(b)
        rev = n % 4 == 3  # exercise the reversal / complement gathers
        meta12[:, n] = (a_off, rev, R, b_off - W, rev, rev, W, W + len(b),
                        b_len[n], lane_k[n], 0, 0)
    a_len = np.full(N, R, np.int32)
    cases = []
    for bound in (False, True):
        if bound:  # tandem-style lanes: a diagonal band around identity
            diag_lo = -rng.integers(1, 300, N).astype(np.int32)
            diag_hi = rng.integers(1, 300, N).astype(np.int32)
        else:
            diag_lo = np.full(N, -DIAG_UNBOUNDED, np.int32)
            diag_hi = np.full(N, DIAG_UNBOUNDED, np.int32)
        chars = np.concatenate([_pack2bit(a_win), _pack2bit(b_win)], axis=1)
        meta = np.concatenate([b_len, lane_k, a_len, diag_lo, diag_hi, num_k])
        tag = f"R={R} N={N} W={W} bound_diag={bound}"
        cases.append((f"_extend_scan_v3_packed {tag}",
                      functools.partial(_extend_scan_v3_packed, R=R, N=N, K=K,
                                        W=W, bound_diag=bound),
                      (chars, meta)))
        m12 = meta12.copy()
        m12[10], m12[11] = diag_lo, diag_hi
        cases.append((f"_extend_scan_v3_resident {tag}",
                      functools.partial(_extend_scan_v3_resident, R=R, N=N,
                                        K=K, W=W, BW=BW, bound_diag=bound),
                      ("arena", m12, num_k)))
    return cases


def _nw_round_case(rng, TB: int, N: int, W: int = 128):
    from dentist_tpu.ops.banded import _pack2bit
    from dentist_tpu.ops.consensus import (TB_nwin, _nw_round_packed_sparse,
                                           _prop_centers)

    RLB = 2 * TB
    tpl = np.zeros((N, TB), np.uint8)
    reads = np.zeros((N, RLB), np.uint8)
    t_lens = np.zeros(N, np.int32)
    read_lens = np.zeros(N, np.int32)
    centers = np.zeros((TB + 1, N), np.int32)
    T = int(0.9 * TB)
    for n in range(N):
        t, r = _aligned(rng, T)
        r = r[:RLB]
        tpl[n, :T], reads[n, : len(r)] = t, r
        t_lens[n], read_lens[n] = T, len(r)
        c = _prop_centers(T, np.array([len(r)]))[:, 0]
        centers[: T + 1, n] = c
        centers[T + 1 :, n] = c[T]
    steps = np.clip(np.diff(centers, axis=0), 0, 2).astype(np.uint8).T
    chars = np.concatenate(
        [_pack2bit(tpl), _pack2bit(reads), _pack2bit(steps)], axis=1)
    meta = np.concatenate([t_lens, read_lens, centers[0]])
    return (f"_nw_round_packed_sparse T={TB} RL={RLB} N={N} W={W}",
            functools.partial(_nw_round_packed_sparse, T=TB, RL=RLB, W=W,
                              S=TB + RLB, NWIN=max(TB_nwin(TB), 1)),
            (chars, meta))


def _window_cases(rng, arena: _HostArena, N: int, W: int = 128):
    from dentist_tpu.ops.banded import _pack2bit
    from dentist_tpu.ops.consensus import (_MARGIN, _SEG, _WS,
                                           _nw_window_round_resident,
                                           _nw_window_round_sparse)

    tpl = np.zeros((N, _WS), np.uint8)
    seg = np.zeros((N, _SEG), np.uint8)
    tlen = np.zeros(N, np.int32)
    slen = np.zeros(N, np.int32)
    tstart = np.zeros(N, np.int32)
    sstart = np.zeros(N, np.int32)
    for n in range(N):
        t, s = _aligned(rng, _WS)
        s = s[:_SEG]
        tpl[n], seg[n, : len(s)] = t, s
        tlen[n], slen[n] = _WS, len(s)
        tstart[n], sstart[n] = arena.put(t), arena.put(s)
    loc0 = np.full(N, _MARGIN, np.int32)
    rows = np.arange(_WS + 1, dtype=np.int32)
    cen = (np.minimum(rows[None, :], tlen[:, None]) * slen[:, None]) // tlen[:, None]
    steps = np.diff(cen, axis=1).clip(0, 2).astype(np.uint8)
    chars = np.concatenate([_pack2bit(tpl), _pack2bit(seg), _pack2bit(steps)],
                           axis=1)
    meta4 = np.stack([tlen, slen, np.zeros(N, np.int32), loc0])
    meta5 = np.stack([tlen, slen, loc0, tstart, sstart])
    return [
        (f"_nw_window_round_sparse N={N} W={W}",
         functools.partial(_nw_window_round_sparse, W=W), (chars, meta4)),
        (f"_nw_window_round_resident N={N} W={W}",
         functools.partial(_nw_window_round_resident, W=W), ("arena", meta5)),
    ]


def _gains_case(rng, V: int, NB: int):
    from dentist_tpu.ops.banded import _pack2bit
    from dentist_tpu.ops.consensus import _nw_dist_pair_packed
    from dentist_tpu.sim.reads import _mutate

    TW, TWp, RW = 34, 36, 48  # the fixed _window_gains_multi geometry
    buf = np.zeros((V, 2 * TWp + NB * RW), np.uint8)
    meta = np.zeros((V, 2 + NB), np.int32)
    for v in range(V):
        win = rng.integers(0, 4, TW).astype(np.uint8)
        ewin = np.delete(win, rng.integers(0, TW))  # a candidate deletion
        buf[v, :TW], buf[v, TWp : TWp + TW - 1] = win, ewin
        meta[v, :2] = TW, TW - 1
        for k in range(NB):
            s = _mutate(win, rng, 0.13)[:RW]
            buf[v, 2 * TWp + k * RW : 2 * TWp + k * RW + len(s)] = s
            meta[v, 2 + k] = len(s)
    return (f"_nw_dist_pair_packed V={V} NB={NB}",
            functools.partial(_nw_dist_pair_packed, TW=TW, TWp=TWp, RW=RW,
                              NB=NB),
            (_pack2bit(buf), meta))


def _arena_write_case(rng):
    from dentist_tpu.ops.banded import _ARENA_CHUNK, RESIDENT_PAD, _arena_write_chunk

    packed = rng.integers(0, 256, _ARENA_CHUNK // 4).astype(np.uint8)
    return (f"_arena_write_chunk chunk={_ARENA_CHUNK}", _arena_write_chunk,
            ("arena", packed, np.int32(RESIDENT_PAD + 4096)))


def kernel_cases(arena_capacity: int, small: bool = False, seed: int = 0):
    """``(name, fn, args)`` for every device kernel family.

    Production widths: extension W=256 at the largest window bucket
    R=32,256; consensus W=128; each at the smallest lane bucket of its
    ladder so the CPU side of the comparison stays short.  ``small``
    gives tiny shapes for tests.  The string ``"arena"`` in ``args``
    stands for the arena image (returned as the second value), which is
    filled while the cases are built.
    """
    from dentist_tpu.ops.aligner import _BUCKETS, _LANE_BUCKETS
    from dentist_tpu.ops.consensus import _N_LADDER, _V_SMALL, _WCHUNK

    rng = np.random.default_rng(seed)
    arena = _HostArena(arena_capacity)
    if small:
        cases = _extension_cases(rng, arena, R=_BUCKETS[0], N=8)
        cases += [_nw_round_case(rng, 512, 8)]
        cases += _window_cases(rng, arena, 16)
        cases += [_gains_case(rng, 8, 8)]
    else:
        cases = _extension_cases(rng, arena, R=_BUCKETS[-1],
                                 N=_LANE_BUCKETS[0])
        cases += [_nw_round_case(rng, TB, _N_LADDER[0]) for TB in (8192, 32768)]
        cases += _window_cases(rng, arena, _WCHUNK)
        cases += [_gains_case(rng, _V_SMALL // 2, 32)]
    cases.append(_arena_write_case(rng))
    return cases, arena.array


def _timed(fn, dargs):
    """``(result, first call incl. compile in s, one warmed call in s)``."""
    t0 = time.perf_counter()
    fn(*dargs).block_until_ready()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = fn(*dargs)
    res.block_until_ready()
    return res, first, time.perf_counter() - t0


def compare_kernels(cases, arena, device, reference, out=print) -> list[dict]:
    """Run each case on ``device`` (compile, then one timed warmed call)
    and on ``reference``; report whether the results are bit-identical."""
    import jax

    def put(args, dev, arena_dev):
        return [arena_dev if isinstance(a, str) else jax.device_put(a, dev)
                for a in args]

    arena_dev = jax.device_put(arena, device)
    results = []
    for name, fn, args in cases:
        res, first, warm = _timed(fn, put(args, device, arena_dev))
        results.append({"name": name, "compile_and_first_s": first,
                        "warm_s": warm, "out": np.asarray(res)})
    del arena_dev
    # the reference runs after the timed calls (no contention); its
    # dispatches are asynchronous, so the cases overlap each other
    arena_ref = jax.device_put(arena, reference)
    pending = [fn(*put(args, reference, arena_ref)) for _, fn, args in cases]
    for r, ref in zip(results, pending):
        ref = np.asarray(ref)
        got = r.pop("out")
        r["shape"] = list(got.shape)
        r["bit_identical"] = bool(got.dtype == ref.dtype
                                  and np.array_equal(got, ref))
        out(f"kernel {r['name']}: out {got.dtype}{r['shape']}, "
            f"bit-identical to {reference.platform}: {r['bit_identical']}, "
            f"warmed call {r['warm_s'] * 1e3:.3f} ms on {device.device_kind} "
            f"(first call incl. compile {r['compile_and_first_s']:.1f} s)")
    return results


def widen_packed(case, reps: int):
    """The packed extension ``case`` with its lanes repeated ``reps``
    times.  Lanes are independent, so the result is the narrow case's
    result repeated along the lane axis."""
    name, fn, (chars, meta) = case
    N = chars.shape[0]
    lanes = np.tile(meta[: 5 * N].reshape(5, N), reps).ravel()
    wide = functools.partial(fn.func, **{**fn.keywords, "N": N * reps})
    return (name.replace(f" N={N} ", f" N={N * reps} "), wide,
            (np.tile(chars, (reps, 1)), np.concatenate([lanes, meta[5 * N:]])))


def check_widened(case, reps: int, device, out=print) -> dict:
    """Time the packed extension ``case`` widened ``reps`` times on
    ``device``, and check that its result is the narrow case's (on the
    same device) repeated: production lane width without a second, much
    longer, CPU reference."""
    import jax

    name, fn, args = widen_packed(case, reps)
    narrow = np.asarray(case[1](*[jax.device_put(a, device) for a in case[2]]))
    res, first, warm = _timed(fn, [jax.device_put(a, device) for a in args])
    got = np.asarray(res)
    r = {"name": name, "compile_and_first_s": first, "warm_s": warm,
         "shape": list(got.shape),
         "bit_identical": bool(np.array_equal(got, np.tile(narrow, (1, reps))))}
    out(f"kernel {name}: out {got.dtype}{r['shape']}, equal to the "
        f"{narrow.shape[1]}-lane result repeated: {r['bit_identical']}, "
        f"warmed call {warm * 1e3:.3f} ms on {device.device_kind} "
        f"(first call incl. compile {first:.1f} s)")
    return r


def _peak_bytes(device) -> int | None:
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def pipeline_phase(mb: float, workdir: str, device, out=print) -> dict:
    """Write the scenario as FASTA, run the CLI pipeline, score it."""
    from dentist_tpu.cli import main as cli_main
    from dentist_tpu.eval.check_results import check_results
    from dentist_tpu.io.fasta import codes_to_seq, read_fasta, write_fasta
    from dentist_tpu.pipeline import STAGE_KEYS
    from dentist_tpu.sim.example import reference_example
    from dentist_tpu.utils.log import STAGE_SECONDS, reset_stage_seconds

    t0 = time.perf_counter()
    truth, records, contigs, structure, reads, _ = reference_example(mb)
    asm_path = os.path.join(workdir, "assembly.fasta")
    reads_path = os.path.join(workdir, "reads.fasta")
    out_path = os.path.join(workdir, "gap-closed.fasta")
    one_line = 1 << 31  # unwrapped sequences: fast to write and to parse
    write_fasta(asm_path, ((r.header, codes_to_seq(r.codes)) for r in records),
                line_width=one_line)
    write_fasta(reads_path, ((f"read{i + 1}", codes_to_seq(r))
                             for i, r in enumerate(reads)), line_width=one_line)
    n_gaps = len(structure.gaps)
    out(f"scenario: {mb:g} Mb, {n_gaps} gaps, {len(reads)} reads "
        f"({sum(len(r) for r in reads) / 1e6:.1f} Mb), "
        f"datagen + FASTA {time.perf_counter() - t0:.1f} s")

    reset_stage_seconds()
    t0 = time.perf_counter()
    rc = cli_main(["pipeline", asm_path, reads_path, out_path])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise SystemExit(f"pipeline exited {rc}")
    result = [r.codes for r in read_fasta(out_path)]
    stats = check_results([truth], structure, contigs, result)
    closed = [g for g in stats.gaps if g.state.value == "closed"]
    res = {
        "gaps": n_gaps, "closed": stats.num_closed,
        "byte_exact": stats.num_correct(1.0),
        "min_identity": min((g.identity for g in closed), default=None),
        "pipeline_s": wall,
        "stage_s": {k: STAGE_SECONDS.get(v, 0.0) for k, v in STAGE_KEYS.items()},
        "peak_bytes_in_use": _peak_bytes(device),
    }
    out(f"pipeline: {res['closed']}/{n_gaps} gaps closed, "
        f"{res['byte_exact']} byte-exact, min identity "
        f"{res['min_identity']}, wall-clock {wall:.1f} s, stage split (s) "
        f"{json.dumps(res['stage_s'])}, peak_bytes_in_use "
        f"{res['peak_bytes_in_use']} on {device.device_kind}")
    if mb == 28 and n_gaps != 147:
        raise SystemExit(f"28 Mb scenario placed {n_gaps} gaps, not 147")
    if res["closed"] < n_gaps:
        raise SystemExit(f"only {res['closed']}/{n_gaps} gaps closed")
    return res


def four_phase(mb: float, devices, out=print) -> dict:
    """``close_gaps`` on the ``dp`` mesh over every device, then forced
    single-device in the same process; outputs must be byte-equal."""
    from jax.sharding import PartitionSpec as P

    from dentist_tpu.parallel.dp import default_mesh, stage_global
    from dentist_tpu.pipeline import PipelineConfig, close_gaps
    from dentist_tpu.sim.example import reference_example

    _, _, contigs, structure, reads, store = reference_example(mb)
    mesh = default_mesh()
    if mesh is None or mesh.size != len(devices):
        raise SystemExit(f"expected a {len(devices)}-device mesh, got {mesh}")
    # where a single-process mesh flush lands before XLA splits it
    staged = stage_global(mesh, P("dp", None), np.zeros((len(devices), 4)))
    out(f"stage_global (one process) places a flush on "
        f"{sorted(str(d) for d in staged.devices())}; a jit over the mesh "
        f"then splits it across {mesh.size} cards")
    del staged

    def run(single: bool):
        if single:
            os.environ["DENTIST_TPU_FORCE_SINGLE"] = "1"
        try:
            t0 = time.perf_counter()
            res = close_gaps(contigs, structure, store, reads,
                             PipelineConfig(read_coverage=20.0))
            return res, time.perf_counter() - t0
        finally:
            os.environ.pop("DENTIST_TPU_FORCE_SINGLE", None)

    mesh_res, mesh_s = run(single=False)
    single_res, single_s = run(single=True)
    same = {"fasta": mesh_res.records == single_res.records,
            "agp": mesh_res.agp_rows == single_res.agp_rows,
            "bed": mesh_res.bed_rows == single_res.bed_rows}
    n_gaps = len(structure.gaps)
    out(f"four: {mb:g} Mb, mesh of {mesh.size} closed "
        f"{mesh_res.n_closed_gaps}/{n_gaps} in {mesh_s:.1f} s, forced "
        f"single device closed {single_res.n_closed_gaps}/{n_gaps} in "
        f"{single_s:.1f} s; byte-equal {same}")
    if not all(same.values()):
        raise SystemExit(f"mesh output differs from single-device: {same}")
    if mesh_res.n_closed_gaps < n_gaps:
        raise SystemExit(f"mesh closed {mesh_res.n_closed_gaps}/{n_gaps}")
    return {"mesh_s": mesh_s, "single_s": single_s, **same}


# ----------------------------------------------------------------------


def _restrict_cards(n: int) -> None:
    """Show JAX only the first ``n`` cards; must run before the backend
    starts (a multi-card host would otherwise auto-shard the pipeline)."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = visible.split(",") if visible else [str(i) for i in range(n)]
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(ids[:n])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=float, default=28.0,
                    help="genome size of the scenario in Mb (default 28)")
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args(argv)
    _restrict_cards(4 if args.four else 1)
    os.environ["DENTIST_TPU_STRICT"] = "1"
    sys.path.insert(0, REPO)

    import jax

    from dentist_tpu.utils.device import (describe, nvidia_smi_name_power,
                                          require_gpu)

    gpu = require_gpu(jax.devices())
    device = describe(jax.devices())
    if args.four and device["count"] != 4:
        raise SystemExit(f"--four needs four cards, JAX sees {device['count']}")
    print(f"device: {device}, jax {jax.__version__}", flush=True)
    for line in nvidia_smi_name_power():
        print(f"card (nvidia-smi name, power.limit): {line}", flush=True)

    from dentist_tpu.utils.cache import enable_compile_cache
    from dentist_tpu.utils.log import tee_log_file

    enable_compile_cache()
    workdir = tempfile.mkdtemp(prefix="chip-smoke-")
    log_path = os.path.join(workdir, "events.log")
    tee_log_file(log_path)
    try:
        subprocess.run(["make", "-B", "-C", os.path.join(REPO, "native")],
                       check=True, capture_output=True, timeout=600)
        from dentist_tpu import native

        if not native.native_available():
            raise SystemExit("native library did not load")
        print(f"native: rebuilt and loaded {native._LIB_PATH}", flush=True)

        if args.four:
            four_phase(args.mb, jax.devices())
        else:
            from dentist_tpu.ops.aligner import _LANE_BUCKETS
            from dentist_tpu.ops.banded import _arena_capacity

            t0 = time.perf_counter()
            cases, arena = kernel_cases(_arena_capacity())
            results = compare_kernels(cases, arena, gpu, jax.devices("cpu")[0],
                                      out=lambda s: print(s, flush=True))
            del arena
            results.append(check_widened(
                cases[0], _LANE_BUCKETS[-1] // _LANE_BUCKETS[0], gpu,
                out=lambda s: print(s, flush=True)))
            del cases
            print(f"kernels: {len(results)} compared in "
                  f"{time.perf_counter() - t0:.1f} s, peak_bytes_in_use "
                  f"{_peak_bytes(gpu)}", flush=True)
            bad = [r["name"] for r in results if not r["bit_identical"]]
            if bad:
                raise SystemExit(f"kernels differ from their reference: {bad}")
            pipeline_phase(args.mb, workdir, gpu,
                           out=lambda s: print(s, flush=True))
    finally:
        tee_log_file(None)
        with open(log_path) as fh:
            events = fallback_events(fh)
        shutil.rmtree(workdir, ignore_errors=True)
    if events:
        raise SystemExit(f"fallback events in the run: {events[:5]}")
    print("fallback events: none", flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
