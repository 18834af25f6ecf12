"""ctypes bindings for the native C++ components (``native/``).

The reference vendors a C++ FM-index for exact contig anchoring in
``check-results`` (``external/fm-index.cpp``, SDSL); our native library
provides the same capability as a SA-IS suffix array with binary-search
locate, plus 2-bit sequence packing (the Dazzler ``.bps`` layout).

The library auto-builds on first use (``make -C native``); every entry
point has a NumPy fallback so the framework works without a compiler.
Each fallback is logged (``nativeBuildFailed``, ``nativeLoadFailed``,
``nativeSymbolMissing``), because the NumPy paths are far slower.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from .utils.log import log_json

__all__ = ["SuffixArrayIndex", "pack_2bit", "unpack_2bit", "native_available"]

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
#: ``DENTIST_TPU_NATIVE`` points at a pre-built library (container
#: images build it once at image-build time); otherwise the repo-local
#: library is used, auto-built via ``make`` on first use
_LIB_PATH = os.environ.get(
    "DENTIST_TPU_NATIVE", os.path.join(_NATIVE_DIR, "libdentistnative.so"))
_lib = None
_tried = False
#: optional entry points; without them seeding runs its NumPy paths
_SEEDING_SYMBOLS = ("dentist_seed_lookup", "dentist_seed_lookup_stream",
                    "dentist_seed_merge")


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if "DENTIST_TPU_NATIVE" not in os.environ:
        try:  # make is a no-op when the library is fresh
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except Exception as exc:  # no compiler / no make: fall back to numpy
            log_json("warn", event="nativeBuildFailed", error=str(exc))
            if not os.path.exists(_LIB_PATH):
                return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as exc:
        log_json("warn", event="nativeLoadFailed", error=str(exc))
        return None
    missing = [s for s in _SEEDING_SYMBOLS if not hasattr(lib, s)]
    if missing:  # a stale library: seeding falls back to NumPy
        log_json("warn", event="nativeSymbolMissing", symbols=missing,
                 path=_LIB_PATH)
    lib.dentist_sa_build.restype = ctypes.c_void_p
    lib.dentist_sa_build.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.dentist_sa_locate.restype = ctypes.c_int64
    lib.dentist_sa_locate.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
    ]
    lib.dentist_sa_free.argtypes = [ctypes.c_void_p]
    lib.dentist_pack_2bit.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p]
    lib.dentist_unpack_2bit.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p]
    if hasattr(lib, "dentist_seed_lookup"):
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.dentist_seed_lookup.restype = None
        lib.dentist_seed_lookup.argtypes = [
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"), i64p,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"), i64p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
            i64p, i64p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
    if hasattr(lib, "dentist_seed_lookup_stream"):
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.dentist_seed_lookup_stream.restype = ctypes.c_int64
        lib.dentist_seed_lookup_stream.argtypes = [
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"), i64p,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"), i64p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
            i64p, i64p, ctypes.c_int64, i64p, i64p,
        ]
    if hasattr(lib, "dentist_seed_merge"):
        lib.dentist_seed_merge.restype = ctypes.c_int64
        lib.dentist_seed_merge.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p,
        ]
    _lib = lib
    return _lib


#: EMA of observed seeds per query k-mer (sizes the stream buffer)
_STREAM_RATE = 0.35


def seed_lookup(qcodes: np.ndarray, qoffs: np.ndarray, k: int, stride: int,
                max_occ: int, unique_kmers: np.ndarray,
                unique_start: np.ndarray, bucket_start: np.ndarray | None,
                bucket_bits: int, sorted_pos: np.ndarray):
    """Native batched k-mer seed lookup; None if the library is absent.

    Returns (offsets (nq+1,), a_pos, b_pos) int64 arrays — query q's
    seeds live at [offsets[q], offsets[q+1]).
    """
    lib = _load()
    if lib is None or not hasattr(lib, "dentist_seed_lookup") or 2 * k > 31:
        return None
    nq = len(qoffs) - 1
    counts = np.zeros(nq, dtype=np.int64)
    bs_ptr = (bucket_start.ctypes.data_as(ctypes.c_void_p)
              if bucket_start is not None else None)
    head = (qcodes, qoffs, nq, k, stride, max_occ,
            unique_kmers, unique_start, len(unique_kmers),
            bs_ptr, bucket_bits, 2 * k, sorted_pos, counts)
    if hasattr(lib, "dentist_seed_lookup_stream"):
        # single-pass protocol: emit while counting.  The capacity
        # tracks the RUN's observed hit rate (seeds per query k-mer,
        # ~0.3 on unique sequence but far higher for repeat-dense
        # batches): an EMA-scaled cap with 2× headroom keeps overflow
        # retries rare without a fixed oversized allocation (ADVICE r3:
        # the static 1× k-mer cap overflowed routinely on repeat storms,
        # degrading to two full passes)
        global _STREAM_RATE
        n_kmers = int(np.maximum(qoffs[1:] - qoffs[:-1] - k, 0).sum() // stride) + nq
        cap = max(int(n_kmers * 2.0 * max(_STREAM_RATE, 0.15)), 1 << 12)
        while True:
            a_pos = np.empty(cap, dtype=np.int64)
            b_pos = np.empty(cap, dtype=np.int64)
            total = int(lib.dentist_seed_lookup_stream(*head, cap, a_pos, b_pos))
            if total <= cap:
                _STREAM_RATE = (0.7 * _STREAM_RATE
                                + 0.3 * (total / max(n_kmers, 1)))
                offsets = np.zeros(nq + 1, dtype=np.int64)
                np.cumsum(counts, out=offsets[1:])
                if 2 * total < cap:
                    # copy out: slim views must not pin the cap-sized
                    # buffers for as long as downstream slices live
                    # (ADVICE r3: 16 B per query k-mer held hostage)
                    a_pos, b_pos = a_pos[:total].copy(), b_pos[:total].copy()
                else:
                    a_pos, b_pos = a_pos[:total], b_pos[:total]
                return offsets, a_pos, b_pos
            cap = total
    args = head
    lib.dentist_seed_lookup(*args, None, None, None)
    offsets = np.zeros(nq + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    total = int(offsets[-1])
    a_pos = np.empty(total, dtype=np.int64)
    b_pos = np.empty(total, dtype=np.int64)
    lib.dentist_seed_lookup(
        *args,
        offsets.ctypes.data_as(ctypes.c_void_p),
        a_pos.ctypes.data_as(ctypes.c_void_p),
        b_pos.ctypes.data_as(ctypes.c_void_p))
    return offsets, a_pos, b_pos


def seed_merge(cols: np.ndarray, max_gap: int, slope_slack: int,
               slope_frac: float):
    """Native greedy merge of band-local seed sub-clusters.

    ``cols``: (M, 6) int64 rows (g, seq, a0, a1, b0, b1) sorted by
    (g, seq, a0, b0).  Returns ``(assign (M,), bounds (K, 6))`` — the
    merged-cluster id of each row (creation order) and each cluster's
    final bounds — or None when the library is absent (the caller keeps
    a pure-Python loop with identical semantics).
    """
    lib = _load()
    if lib is None or not hasattr(lib, "dentist_seed_merge"):
        return None
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    M = len(cols)
    assign = np.empty(M, dtype=np.int64)
    bounds = np.empty((M, 6), dtype=np.int64)
    K = int(lib.dentist_seed_merge(
        cols.ctypes.data_as(ctypes.c_void_p), M, max_gap, slope_slack,
        ctypes.c_double(slope_frac),
        assign.ctypes.data_as(ctypes.c_void_p),
        bounds.ctypes.data_as(ctypes.c_void_p)))
    return assign, bounds[:K]


def native_available() -> bool:
    return _load() is not None


class SuffixArrayIndex:
    """Exact substring locator over coded DNA (0..3; 4 = separator)."""

    def __init__(self, codes: np.ndarray):
        self.codes = np.ascontiguousarray(codes, dtype=np.uint8)
        lib = _load()
        self._handle = None
        if lib is not None:
            self._lib = lib
            self._handle = ctypes.c_void_p(lib.dentist_sa_build(
                self.codes.ctypes.data_as(ctypes.c_char_p), len(self.codes)))

    def locate(self, pattern: np.ndarray, max_out: int = 64) -> np.ndarray:
        """All exact occurrence positions (up to max_out), sorted."""
        pattern = np.ascontiguousarray(pattern, dtype=np.uint8)
        if self._handle is not None:
            out = np.zeros(max_out, dtype=np.int64)
            n = self._lib.dentist_sa_locate(
                self._handle, pattern.ctypes.data_as(ctypes.c_char_p),
                len(pattern), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                max_out,
            )
            return np.sort(out[: min(n, max_out)])
        return self._locate_numpy(pattern, max_out)

    def _locate_numpy(self, pattern: np.ndarray, max_out: int) -> np.ndarray:
        m = len(pattern)
        if m == 0 or m > len(self.codes):
            return np.empty(0, dtype=np.int64)
        k = min(m, 32)
        win = np.lib.stride_tricks.sliding_window_view(self.codes, k)
        cand = np.flatnonzero((win == pattern[:k]).all(axis=1))
        hits = [c for c in cand
                if c + m <= len(self.codes)
                and np.array_equal(self.codes[c : c + m], pattern)]
        return np.array(hits[:max_out], dtype=np.int64)

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            try:
                self._lib.dentist_sa_free(self._handle)
            except Exception:
                pass


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """4 bases per byte, first base in the HIGH bits of each byte — the
    Dazzler ``.bps`` layout (DAZZ_DB ``Compress_Read``), so packed arrays
    diff cleanly against reference-produced ``.bps`` files."""
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    lib = _load()
    out = np.zeros((len(codes) + 3) // 4, dtype=np.uint8)
    if lib is not None:
        lib.dentist_pack_2bit(codes.ctypes.data_as(ctypes.c_char_p), len(codes),
                              out.ctypes.data_as(ctypes.c_char_p))
        return out
    for lane in range(4):
        part = codes[lane::4] & 0x3
        out[: len(part)] |= part << (2 * (3 - lane))
    return out


def unpack_2bit(packed: np.ndarray, n: int) -> np.ndarray:
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    lib = _load()
    out = np.zeros(n, dtype=np.uint8)
    if lib is not None:
        lib.dentist_unpack_2bit(packed.ctypes.data_as(ctypes.c_char_p), n,
                                out.ctypes.data_as(ctypes.c_char_p))
        return out
    for lane in range(4):
        vals = (packed >> (2 * (3 - lane))) & 0x3
        take = len(out[lane::4])
        out[lane::4] = vals[:take]
    return out
