"""Batched banded edit-distance extension DP — the alignment wavefront.

This is the batched-device replacement for daligner's O(nd) wave extension
(SURVEY §2.3: "banded DP kernel"): a seed-anchored, *band-following*
edit-distance DP, batched over many candidate alignments at once.

Design for the hardware:

- The DP runs one **row per consumed A base** (``lax.scan``), carrying a
  ``(batch, W)`` wavefront of edit distances.  All three recurrence
  predecessors are expressed without intra-row sequential dependency: the
  horizontal (B-insertion) closure ``D[j] = min_{q≤j} tmp[q] + (j-q)`` is
  a **prefix-min associative scan** over the band (log₂ W depth)
  instead of a serial sweep.
- The band *follows the seeds*: a per-row band center interpolated
  through the seed positions is supplied by the caller, so W stays small
  (128) even though indel drift over a 25 kb read exceeds any fixed band.
- Shapes are static per bucket: candidates are bucketed by window length
  by the caller; one compilation per bucket.
- Anchors are snapped to multiples of the trace spacing (126) by the
  caller, so trace rows are the same static rows for every lane of the
  batch — per-row best-cell state is emitted and trace points extracted
  on the host.

The kernel returns per-row ``(best_j, best_d, best_s)`` where score
``S = (r + j) - diff_penalty · D`` implements daligner's ≤30 %-error
local-alignment criterion (break-even error 2/diff_penalty per base).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["extend_batch", "extend_batch_multi_async", "unpack_extension",
           "extend_batch_packed_async", "bw_for", "sharded_extend_v3",
           "DIFF_PENALTY", "INF"]

DIFF_PENALTY = 6  # score = advance - 6*diffs → break-even at ~33% error
INF = np.int32(1 << 28)

import os

#: scan unroll factor: the row loop is sequential and each row's work is
#: small, so per-iteration overhead matters; unrolling amortizes it at
#: the cost of compile time (2 was tuned on the former remote backend;
#: unmeasured on the GPU)
_UNROLL = int(os.environ.get("DENTIST_TPU_SCAN_UNROLL", "2"))
#: diag_lo/diag_hi sentinel: larger than any band coordinate
DIAG_UNBOUNDED = np.int32(1 << 20)


#: rows per scan step: the (N, W + 2·_CHUNK) B window is refilled from
#: b_win once per chunk (K dynamic slices) and *shifted* within it, so
#: the R-step loop has zero memory traffic; divides every window bucket
_CHUNK = 42


@functools.partial(jax.jit, static_argnames=("W", "bound_diag"))
def _extend_scan_v3(a_chars, b_win, b_len, offs_k, lane_k, a_len,
                    diag_lo, diag_hi, W: int, bound_diag: bool = True):
    """Multi-schedule variant of :func:`_extend_scan_v2`.

    ``offs_k`` is (R+1, K): K linear band schedules per flush; ``lane_k``
    (N,) picks each lane's schedule.  One dispatch serves every slope
    group of a window bucket.

    The band advances 0..2 columns per row, so the scan runs in chunks of
    ``_CHUNK`` rows: each chunk refills a (N, W + 2·_CHUNK) window+
    lookahead buffer from ``b_win`` (K dynamic slices per *chunk* — the
    original K slices per *row* were the kernel's whole cost) and the
    unrolled inner rows shift it in registers (``b_ch(r)[p] =
    B[off_r + p − 1]``).

    ``diag_lo``/``diag_hi`` (N,) bound each lane's allowed diagonal
    ``j − r``: cells outside are infeasible.  Self-alignment (tandem)
    lanes use this to exclude the identity diagonal, which would
    otherwise win every comparison of a sequence against itself
    (datander's split-DP has the same constraint); ``bound_diag=False``
    (ordinary lanes) skips the per-row masking.
    """
    a_chars = a_chars.astype(jnp.int32)
    R, N = a_chars.shape
    K = offs_k.shape[1]
    C = _CHUNK
    assert R % C == 0, f"window bucket {R} must be a multiple of {C}"
    NC = R // C
    WB = W + 2 * C  # window + worst-case lookahead (shift ≤ 2/row)
    p = jnp.arange(W, dtype=jnp.int32)
    lane_k = lane_k.astype(jnp.int32)
    diag_lo = diag_lo.astype(jnp.int32)[:, None]
    diag_hi = diag_hi.astype(jnp.int32)[:, None]

    off0 = offs_k[0, 0]  # schedules share row 0: off = −W//2
    j0 = off0 + p[None, :]
    ok0 = (j0 >= 0) & (j0 <= b_len[:, None]) & (j0 >= diag_lo) & (j0 <= diag_hi)
    D0 = jnp.broadcast_to(jnp.where(ok0, j0, INF), (N, W)).astype(jnp.int32)

    # per-lane schedule offsets resolved to (R, N) via K-way select —
    # vector selects beat a [:, lane_k] gather by two orders of magnitude
    off_lane = jnp.zeros((R, N), jnp.int32)
    for k in range(K):
        off_lane = jnp.where(lane_k[None, :] == k, offs_k[1:, k : k + 1],
                             off_lane)
    s_lane = jnp.concatenate([off_lane[:1] - off0, jnp.diff(off_lane, axis=0)],
                             axis=0)  # {0,1,2}

    a_cnk = a_chars.reshape(NC, C, N)
    off_cnk = off_lane.reshape(NC, C, N)
    s_cnk = s_lane.reshape(NC, C, N)
    off_r0 = offs_k[1::C, :]  # (NC, K): offset at each chunk's first row
    rows0 = jnp.arange(1, R + 1, C, dtype=jnp.int32)
    lane_sel = [(lane_k == k)[:, None] for k in range(K)]

    #: the row winner is found with ONE max-reduction over a packed key:
    #: maximizing S = (r + off + p) − 6·D over the row is maximizing
    #: M = p − 6·D, and packing (M << 9) | (511 − p) makes the reduction
    #: also yield the *first* best cell (smallest p); D is then recovered
    #: as (p − M) / 6 — no argmax, no tie-break min, no gathers.
    NEG = jnp.int32(-(1 << 30))

    inf_col = jnp.full((N, 1), INF, jnp.int32)

    def row_body(carry, xs):
        D_prev, b_buf, jm, dm, best_s, best_r, best_j, best_d = carry
        a_ch, off_row, s_row, r, shift_b = xs
        off_cur = off_row[:, None]  # (N,1)
        s = s_row[:, None]  # (N,1) in {0,1,2}
        sh0 = D_prev
        sh1 = jnp.concatenate([D_prev[:, 1:], inf_col], axis=1)
        sh2 = jnp.concatenate([D_prev[:, 2:], inf_col, inf_col], axis=1)
        E = jnp.where(s == 0, sh0, jnp.where(s == 1, sh1, sh2))
        shm1 = jnp.concatenate([inf_col, D_prev[:, :-1]], axis=1)
        E1 = jnp.where(s == 0, shm1, jnp.where(s == 1, sh0, sh1))

        # the refill already sits at the chunk's first row: shift_b = 0
        # there, 1 elsewhere (circular shift; the wrapped garbage stays
        # within the ≤ 2·C lookahead margin, beyond every window read)
        bb1 = jnp.concatenate([b_buf[:, 1:], b_buf[:, :1]], axis=1)
        bb2 = jnp.concatenate([b_buf[:, 2:], b_buf[:, :2]], axis=1)
        sb = s * shift_b
        b_buf = jnp.where(sb == 0, b_buf, jnp.where(sb == 1, bb1, bb2))
        b_ch = b_buf[:, :W]
        sub = (a_ch[:, None] != b_ch).astype(jnp.int32)

        j = off_cur + p[None, :]
        diag = jnp.where(j >= 1, E1 + sub, INF)
        tmp = jnp.minimum(diag, E + 1)
        valid = (j >= 0) & (j <= b_len[:, None])
        if bound_diag:
            valid &= (j - r >= diag_lo) & (j - r <= diag_hi)
        tmp = jnp.where(valid, tmp, INF)
        closed = jax.lax.associative_scan(jnp.minimum, tmp - p[None, :],
                                          axis=1)
        D = jnp.minimum(tmp, closed + p[None, :])

        key = ((p[None, :] - DIFF_PENALTY * D) << 9) | (W - 1 - p[None, :])
        key = jnp.where(valid & (D < INF) & (r <= a_len)[..., None], key, NEG)
        row_key = key.max(axis=1)
        row_m = row_key >> 9
        row_p = (W - 1) - (row_key & (2 * W - 1))
        row_s = jnp.where(row_key == NEG, -INF, r + off_row + row_m)
        row_j = off_row + row_p
        row_d = (row_p - row_m) // DIFF_PENALTY
        ok = row_key != NEG
        jm = jnp.where(ok, jnp.maximum(jm, row_j), jm)
        dm = jnp.where(ok, jnp.maximum(dm, row_d), dm)
        better = row_s > best_s
        best_s = jnp.where(better, row_s, best_s)
        best_r = jnp.where(better, r, best_r)
        best_j = jnp.where(better, jm, best_j)
        best_d = jnp.where(better, dm, best_d)
        D = jnp.where(valid, jnp.minimum(D, INF), INF)
        # one packed (jm, dm) word per row halves the output traffic
        return (D, b_buf, jm, dm, best_s, best_r, best_j, best_d), \
            (jm << 15) | jnp.minimum(dm, (1 << 15) - 1)

    shift_b = jnp.concatenate([jnp.zeros(1, jnp.int32),
                               jnp.ones(C - 1, jnp.int32)])

    def chunk(carry, xs):
        D_prev, jm, dm, best_s, best_r, best_j, best_d = carry
        a_c, off_c, s_c, off0_k, r0 = xs
        # refill: window at this chunk's first row plus 2·C lookahead
        b_buf = jnp.zeros((N, WB), dtype=b_win.dtype)
        for k in range(K):
            blk = jax.lax.dynamic_slice(b_win, (0, off0_k[k] - 1 + W), (N, WB))
            b_buf = jnp.where(lane_sel[k], blk, b_buf)
        b_buf = b_buf.astype(jnp.int32)
        rows_c = r0 + jnp.arange(C, dtype=jnp.int32)
        init = (D_prev, b_buf, jm, dm, best_s, best_r, best_j, best_d)
        (D, _, jm, dm, best_s, best_r, best_j, best_d), ys = jax.lax.scan(
            row_body, init, (a_c, off_c, s_c, rows_c, shift_b), unroll=_UNROLL)
        return (D, jm, dm, best_s, best_r, best_j, best_d), ys

    xs = (a_cnk, off_cnk, s_cnk, off_r0, rows0)
    # carries derive from `b_len` (not fresh constants) so their varying
    # axes match the body outputs when this runs inside shard_map
    zero = jnp.zeros_like(b_len)
    init = (D0, zero, zero, jnp.full_like(b_len, -INF), zero, zero, zero)
    (_, _, _, best_s, best_r, best_j, best_d), jd_cnk = jax.lax.scan(
        chunk, init, xs)

    from ..models.alignments import TRACE_SPACING

    jd = jd_cnk.reshape(R, N)[TRACE_SPACING - 1 :: TRACE_SPACING]
    # ONE packed (4 + T, N) output: one device-to-host copy per dispatch
    # instead of five; rows 0..3 are best_r/j/d/s, rows 4.. the packed
    # (jm << 15 | dm) trace samples — split on the host by
    # :func:`unpack_extension`.
    return jnp.concatenate(
        [best_r[None], best_j[None], best_d[None], best_s[None], jd], axis=0)


def bw_for(R: int, W: int) -> int:
    """B-window width for an R-row bucket, rounded to a 2-bit-pack multiple."""
    bw = int(1.4 * R) + 2 * W + 8
    return -(-bw // 4) * 4


def _pack2bit(a: np.ndarray) -> np.ndarray:
    """(N, X) 2-bit codes → (N, X//4) bytes, first base in the high bits
    (the Dazzler ``Compress_Read`` byte order; X must be a multiple of 4).

    Uses the native word-wise packer when available (~8× the numpy path;
    host packing was 20 % of the consensus stage's host profile)."""
    from ..native import _load as _native_load

    lib = _native_load()
    if lib is not None:
        flat = np.ascontiguousarray(a, dtype=np.uint8).reshape(-1)
        out = np.empty(flat.size // 4, dtype=np.uint8)
        import ctypes

        lib.dentist_pack_2bit(flat.ctypes.data_as(ctypes.c_char_p), flat.size,
                              out.ctypes.data_as(ctypes.c_char_p))
        return out.reshape(a.shape[0], -1)
    q = np.ascontiguousarray(a, dtype=np.uint8).reshape(a.shape[0], -1, 4)
    out = q[:, :, 0] << 6
    out |= q[:, :, 1] << 4
    out |= q[:, :, 2] << 2
    out |= q[:, :, 3]
    return out


@functools.partial(jax.jit, static_argnames=("R", "N", "K", "W", "bound_diag"))
def _extend_scan_v3_packed(chars_pack, meta, R: int, N: int, K: int, W: int,
                           bound_diag: bool = True):
    """:func:`_extend_scan_v3` fed from ONE packed transfer.

    The eight per-dispatch input arrays are collapsed into two host-to-
    device copies: ``chars_pack`` (N, R/4 + BW/4) uint8 — the A and
    B characters 2-bit packed, 4× fewer bytes — and ``meta``
    (5N + K,) int32 = [b_len | lane_k | a_len | diag_lo | diag_hi |
    num_k].  The K band schedules are reconstructed on device from their
    rational slopes (``offs_k[r, k] = (r·num_k)//R − W/2``), which is how
    the host built them (`aligner._flush_group`).
    """
    RP = R // 4
    a_chars = _unpack2bit(chars_pack[:, :RP]).T  # (R, N)
    b_win = _unpack2bit(chars_pack[:, RP:])
    b_len = meta[0 * N : 1 * N]
    lane_k = meta[1 * N : 2 * N]
    a_len = meta[2 * N : 3 * N]
    diag_lo = meta[3 * N : 4 * N]
    diag_hi = meta[4 * N : 5 * N]
    num_k = meta[5 * N : 5 * N + K]
    rows = jnp.arange(R + 1, dtype=jnp.int32)[:, None]
    offs_k = (rows * num_k[None, :]) // R - (W // 2)
    return _extend_scan_v3(a_chars, b_win, b_len, offs_k, lane_k, a_len,
                           diag_lo, diag_hi, W=W, bound_diag=bound_diag)


def _unpack2bit(p):
    """(N, X/4) packed bytes → (N, X) codes on device (inverse of
    :func:`_pack2bit`; gather-free: broadcast shift + reshape)."""
    sh = jnp.array([6, 4, 2, 0], dtype=jnp.uint8)
    return ((p[:, :, None] >> sh[None, None, :]) & 3).reshape(p.shape[0], -1)


def extend_batch_packed_async(a_win, b_win, a_len, b_len, num_k, lane_k,
                              W: int = 256, diag_lo=None, diag_hi=None,
                              mesh=None):
    """Single-transfer dispatch of the multi-schedule extension.

    Same result as :func:`extend_batch_multi_async` with
    ``offs_k[r, k] = (r·num_k[k])//R − W/2``; inputs are 2-bit packed and
    shipped as two arrays (chars + int32 metadata) instead of eight.  ``b_win``
    must be ``bw_for(R, W)`` wide.  Consume via :func:`unpack_extension`.

    With ``mesh`` (>1 device) the packed transfer shards on the ``dp``
    axis (lanes must be padded to a mesh-size multiple) with allgathered
    outputs — identical results to the single-device path.
    """
    N, R = a_win.shape
    K = len(num_k)
    if diag_lo is None:
        diag_lo = np.full(N, -DIAG_UNBOUNDED, dtype=np.int32)
    if diag_hi is None:
        diag_hi = np.full(N, DIAG_UNBOUNDED, dtype=np.int32)
    bound_diag = bool(np.any(np.asarray(diag_lo) != -DIAG_UNBOUNDED)
                      or np.any(np.asarray(diag_hi) != DIAG_UNBOUNDED))
    chars_pack = np.concatenate([_pack2bit(a_win), _pack2bit(b_win)], axis=1)
    if mesh is not None and mesh.size > 1:
        from jax.sharding import PartitionSpec as P

        from ..parallel.dp import stage_global

        meta5 = np.stack([
            np.asarray(b_len, dtype=np.int32),
            np.asarray(lane_k, dtype=np.int32),
            np.asarray(a_len, dtype=np.int32),
            np.asarray(diag_lo, dtype=np.int32),
            np.asarray(diag_hi, dtype=np.int32),
        ])
        return sharded_extend_v3_packed(mesh, R, K, W, bound_diag)(
            stage_global(mesh, P("dp", None), chars_pack),
            stage_global(mesh, P(None, "dp"), meta5),
            stage_global(mesh, P(), np.asarray(num_k, dtype=np.int32)))
    meta = np.concatenate([
        np.asarray(b_len, dtype=np.int32),
        np.asarray(lane_k, dtype=np.int32),
        np.asarray(a_len, dtype=np.int32),
        np.asarray(diag_lo, dtype=np.int32),
        np.asarray(diag_hi, dtype=np.int32),
        np.asarray(num_k, dtype=np.int32),
    ])
    return _extend_scan_v3_packed(jnp.asarray(chars_pack), jnp.asarray(meta),
                                  R=R, N=N, K=K, W=W, bound_diag=bound_diag)


# ======================================================================
# Device sequence arena: resident stores, extension windows gathered on device
# ======================================================================

#: zero margin at the arena start (and kept free at its end): every
#: window slice of any bucket fits without start clamping (≥ max bucket
#: row count and ≥ the widest ``bw_for`` B window)
RESIDENT_PAD = 46464

#: upload-chunk length buckets (chars): uploads pad to the next bucket
#: so the arena-write program compiles per bucket, not per store length
_RESIDENT_LADDER = [-(-int(65536 * 1.5 ** k) // 4096) * 4096
                    for k in range(40)]


def _arena_capacity() -> int:
    """Fixed arena size: the kernels' compiled shapes depend on it, so
    it must be ONE constant per backend session (a per-store size would
    mint a fresh compile zoo per scenario — the round-5 profiling trap).
    Capped below 2^31 (window coordinates travel as int32).  Stores that
    cannot fit raise; callers fall back to host-window dispatch.

    Any accelerator gets 2 GiB − 16 MiB, CPU backends 128 MiB.  The
    accelerator size dates from the former remote backend and is
    unmeasured on the GPU.
    """
    mb = os.environ.get("DENTIST_TPU_ARENA_MB")
    if mb:
        return min(int(mb) << 20, (1 << 31) - (1 << 24))
    import jax

    return ((1 << 31) - (1 << 24) if jax.default_backend() != "cpu"
            else (1 << 27))


class _Arena:
    """Bump-allocated device u8 store shared by every resident kernel.

    Stores upload 2-bit packed (bucketed lengths) and are unpacked into
    the arena with ``dynamic_update_slice``.  ``epoch`` increments on
    reset (arena full); holders of raw offsets must re-upload when it
    changes.
    """

    def __init__(self):
        import threading

        self.array = None
        self.pos = RESIDENT_PAD
        self.keys: dict = {}  # id(codes) -> (offset, keepalive)
        self.epoch = 0
        #: uploads happen from dispatch-pool threads; unguarded
        #: concurrent bump allocation would hand out overlapping regions
        self.lock = threading.RLock()

    def _ensure(self):
        if self.array is None:
            self.array = jnp.zeros(_arena_capacity(), jnp.uint8)

    def reset(self):
        with self.lock:
            self._reset_locked()

    def _reset_locked(self):
        self.pos = RESIDENT_PAD
        self.keys.clear()
        self.epoch += 1
        self.array = jnp.zeros(_arena_capacity(), jnp.uint8)

    def offset_of(self, codes: np.ndarray, cache: bool = True) -> int:
        """Upload ``codes`` (if not already resident); returns its arena
        offset.  Read ``.array`` AFTER this call — uploads replace it
        (writes chain, so any later ``.array`` holds this upload)."""
        with self.lock:
            self._ensure()
            key = id(codes)
            if cache:
                hit = self.keys.get(key)
                if hit is not None and hit[1] is codes:
                    return hit[0]
            L = len(codes)
            L4 = -(-max(L, 4) // 4) * 4
            Lb = next(b for b in _RESIDENT_LADDER if L4 <= b)
            # writes go in whole chunks; the zero tail of the last chunk
            # lands in not-yet-allocated space (already zero, and the
            # next region's own write overwrites it)
            Lw = -(-L4 // _ARENA_CHUNK) * _ARENA_CHUNK
            if self.pos + max(Lb, Lw) + RESIDENT_PAD > _arena_capacity():
                self._reset_locked()
                if self.pos + max(Lb, Lw) + RESIDENT_PAD > _arena_capacity():
                    raise MemoryError(
                        f"store of {L} chars exceeds the device arena "
                        f"({_arena_capacity() >> 20} MiB); raise "
                        f"DENTIST_TPU_ARENA_MB")
            host = np.zeros(L4, dtype=np.uint8)
            host[:L] = codes
            packed = np.zeros(Lw // 4, dtype=np.uint8)
            packed[: L4 // 4] = _pack2bit(host.reshape(1, -1))[0]
            off = self.pos
            for c0 in range(0, Lw, _ARENA_CHUNK):
                self.array = _arena_write_chunk(
                    self.array,
                    jnp.asarray(packed[c0 // 4 : (c0 + _ARENA_CHUNK) // 4]),
                    jnp.int32(off + c0))
            self.pos += Lb
            if cache:
                self.keys[key] = (off, codes)
            return off


#: chars per arena-write step: the unpack stays 1-D (a ``(X, 4)``-minor
#: intermediate can be tile-padded by the compiler — one such layout ran
#: a 582 Mchar store out of device memory)
_ARENA_CHUNK = 1 << 22


@jax.jit
def _arena_write_chunk(arena, packed_c, off):
    # NOT donated: in-flight async dispatches may still read the old
    # arena (donation deletes their input buffer); the full-array copy
    # stays on device — only ``packed_c`` comes from the host.
    # 1-D gather unpack: out[i] = (packed[i>>2] >> shift) & 3.
    idx = jnp.arange(_ARENA_CHUNK, dtype=jnp.int32)
    shift = (jnp.int32(6) - ((idx & 3) << 1)).astype(jnp.uint8)
    vals = (packed_c[idx >> 2] >> shift) & 3
    return jax.lax.dynamic_update_slice(arena, vals, (off,))


ARENA = _Arena()


@functools.partial(jax.jit, static_argnames=("R", "N", "K", "W", "BW",
                                             "bound_diag"))
def _extend_scan_v3_resident(arena, meta12, num_k, R: int, N: int, K: int,
                             W: int, BW: int, bound_diag: bool = True):
    """:func:`_extend_scan_v3` fed from the device sequence arena.

    ``meta12`` (12, N) int32 rows: a_start, a_rev, a_len, b_start, b_rev,
    b_flip, c_lo, c_hi, b_len, lane_k, diag_lo, diag_hi.  Start indices
    are absolute into the arena; the A/B windows the host used to
    assemble (and ship) per lane are gathered here as N contiguous
    slices (one XLA gather each), reversed/complemented per lane, and
    zero-masked outside the valid range — byte-identical inputs to the
    host-window path, hence byte-identical outputs.  The arena shape is
    a backend constant, so this compiles once per (R, N) — like the
    host-window kernels, unlike per-store resident arrays.
    """
    (a_start, a_rev, a_len, b_start, b_rev, b_flip, c_lo, c_hi, b_len,
     lane_k, diag_lo, diag_hi) = meta12

    a_rows = jax.vmap(
        lambda s: jax.lax.dynamic_slice(arena, (s,), (R,)))(a_start)  # (N, R)
    a_rows = jnp.where(a_rev[:, None] == 1, a_rows[:, ::-1], a_rows)
    r_idx = jnp.arange(R, dtype=jnp.int32)
    a_rows = jnp.where(r_idx[None, :] < a_len[:, None], a_rows, 0)

    b_rows = jax.vmap(
        lambda s: jax.lax.dynamic_slice(arena, (s,), (BW,)))(b_start)  # (N, BW)
    b_rows = jnp.where(b_rev[:, None] == 1, b_rows[:, ::-1], b_rows)
    b_rows = jnp.where(b_flip[:, None] == 1, 3 - b_rows, b_rows)
    c = jnp.arange(BW, dtype=jnp.int32)
    b_win = jnp.where((c_lo[:, None] <= c[None, :])
                      & (c[None, :] < c_hi[:, None]), b_rows, 0)

    rows = jnp.arange(R + 1, dtype=jnp.int32)[:, None]
    offs_k = (rows * num_k[None, :]) // R - (W // 2)
    return _extend_scan_v3(a_rows.T, b_win, b_len, offs_k, lane_k, a_len,
                           diag_lo, diag_hi, W=W, bound_diag=bound_diag)


def extend_batch_resident_async(arena, meta12: np.ndarray,
                                num_k: np.ndarray, R: int, W: int = 256):
    """Dispatch the extension against the device arena.

    ``meta12`` — see :func:`_extend_scan_v3_resident`; consume the packed
    result via :func:`unpack_extension`.  Single-device only (the mesh
    path ships host-assembled windows, which shard naturally).
    """
    N = meta12.shape[1]
    bound_diag = bool(np.any(meta12[10] != -DIAG_UNBOUNDED)
                      or np.any(meta12[11] != DIAG_UNBOUNDED))
    return _extend_scan_v3_resident(
        arena, jnp.asarray(meta12),
        jnp.asarray(np.asarray(num_k, dtype=np.int32)),
        R=R, N=N, K=len(num_k), W=W, BW=bw_for(R, W), bound_diag=bound_diag)


@functools.partial(jax.jit, static_argnames=("R", "N", "K", "W", "bound_diag"))
def _extend_scan_v3_packed2(chars_pack, meta5, num_k, R: int, N: int, K: int,
                            W: int, bound_diag: bool = True):
    """:func:`_extend_scan_v3_packed` with the metadata as (5, N) rows +
    replicated ``num_k`` — the layout whose lane axis shards cleanly
    under ``shard_map`` (the flat 5N+K concat mixes per-lane and
    replicated segments, which has no consistent PartitionSpec)."""
    RP = R // 4
    a_chars = _unpack2bit(chars_pack[:, :RP]).T  # (R, N)
    b_win = _unpack2bit(chars_pack[:, RP:])
    b_len, lane_k, a_len, diag_lo, diag_hi = (
        meta5[0], meta5[1], meta5[2], meta5[3], meta5[4])
    rows = jnp.arange(R + 1, dtype=jnp.int32)[:, None]
    offs_k = (rows * num_k[None, :]) // R - (W // 2)
    return _extend_scan_v3(a_chars, b_win, b_len, offs_k, lane_k, a_len,
                           diag_lo, diag_hi, W=W, bound_diag=bound_diag)


#: compiled sharded kernels keyed by (mesh devices, W) — shard_map closures
#: capture the mesh, so reuse them across flushes
_SHARDED_V3_CACHE: dict = {}


#: compiled sharded PACKED kernels keyed by (mesh devices, shape)
_SHARDED_V3P_CACHE: dict = {}


def sharded_extend_v3_packed(mesh, R: int, K: int, W: int,
                             bound_diag: bool = True):
    """:func:`_extend_scan_v3_packed2` under ``shard_map`` over ``mesh``.

    The mesh path ships the same 2-bit packed transfer as the
    single-device path (not eight unpacked arrays per flush).  Lanes
    (chars + per-lane metadata rows) shard on ``dp``; the K band-schedule
    slopes are replicated; outputs are allgathered.  Per-lane math is the
    single-device kernel, so sharded == single-device exactly
    (``tests/test_parallel.py::test_packed_dispatch_equals_multi_array``).
    """
    key = (tuple(d.id for d in mesh.devices.flat), R, K, W, bound_diag)
    fn = _SHARDED_V3P_CACHE.get(key)
    if fn is not None:
        return fn
    from jax.sharding import PartitionSpec as P

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("dp", None), P(None, "dp"), P()),
        out_specs=P(),
        check_vma=False,  # the trailing all_gather replicates the output
    )
    def step(chars_pack, meta5, num_k):
        N_local = chars_pack.shape[0]
        packed = _extend_scan_v3_packed2(
            chars_pack, meta5, num_k, R=R, N=N_local, K=K, W=W,
            bound_diag=bound_diag)
        return jax.lax.all_gather(packed, "dp", axis=1, tiled=True)

    _SHARDED_V3P_CACHE[key] = step
    return fn or step


def sharded_extend_v3(mesh, W: int, bound_diag: bool = True):
    """The production extension kernel under ``shard_map`` over ``mesh``.

    This is the framework's block data-parallelism (SURVEY §2.4): lanes of
    a flush (independent candidate alignments) are sharded on ``dp``, the
    K band schedules (``offs_k``) are replicated, and the per-lane outputs
    are **allgathered** so every device (host, in a multi-host pod) holds
    the full record set — the collective replacing the reference's
    file-level ``LAmerge`` (``snakemake/Snakefile:1025-1037``).

    Per-lane math is identical to the single-device kernel, so sharded
    output == single-device output exactly (asserted by
    ``tests/test_parallel.py`` and the driver's ``dryrun_multichip``).
    """
    key = (tuple(d.id for d in mesh.devices.flat), W, bound_diag)
    fn = _SHARDED_V3_CACHE.get(key)
    if fn is not None:
        return fn
    from jax.sharding import PartitionSpec as P

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(None, "dp"), P("dp", None), P("dp"), P(), P("dp"), P("dp"),
                  P("dp"), P("dp")),
        out_specs=P(),
        # outputs are replicated by the trailing all_gather; the static
        # varying-axis checker cannot infer that
        check_vma=False,
    )
    def step(a_chars, b_win, b_len, offs_k, lane_k, a_len, diag_lo, diag_hi):
        packed = _extend_scan_v3(
            a_chars, b_win, b_len, offs_k, lane_k, a_len, diag_lo, diag_hi,
            W=W, bound_diag=bound_diag)
        return jax.lax.all_gather(packed, "dp", axis=1, tiled=True)

    _SHARDED_V3_CACHE[key] = step
    return step


def unpack_extension(packed) -> tuple:
    """Fetch + split a packed extension result (ONE device-to-host copy).

    Returns ``(best_r, best_j, best_d, best_s, trace_j, trace_d)`` numpy
    arrays; trace rows sample DP rows 126, 252, … (trace_d saturates at
    2^15−1, far beyond any acceptable alignment's diff count).
    """
    arr = np.asarray(packed)
    jd = arr[4:]
    return (arr[0], arr[1], arr[2], arr[3], jd >> 15, jd & ((1 << 15) - 1))


def extend_batch_multi_async(a_win, b_win, a_len, b_len, offs_k, lane_k,
                             W: int = 256, mesh=None, diag_lo=None,
                             diag_hi=None):
    """Dispatch the multi-schedule extension (see ``_extend_scan_v3``).

    Returns the packed device array; consume via :func:`unpack_extension`.

    With ``mesh`` (>1 device) the dispatch runs data-parallel over the
    mesh's ``dp`` axis; lanes must be padded to a multiple of the mesh
    size by the caller.  ``diag_lo``/``diag_hi`` optionally bound each
    lane's allowed diagonal (self-alignment identity exclusion).
    """
    N = len(b_len)
    if diag_lo is None:
        diag_lo = np.full(N, -DIAG_UNBOUNDED, dtype=np.int32)
    if diag_hi is None:
        diag_hi = np.full(N, DIAG_UNBOUNDED, dtype=np.int32)
    # unbounded lanes (the common case) skip the per-row diag masking
    bound_diag = bool(np.any(np.asarray(diag_lo) != -DIAG_UNBOUNDED)
                      or np.any(np.asarray(diag_hi) != DIAG_UNBOUNDED))
    host_args = (
        np.ascontiguousarray(a_win.T).astype(np.uint8),
        np.asarray(b_win, dtype=np.uint8),
        np.asarray(b_len, dtype=np.int32),
        np.asarray(offs_k, dtype=np.int32),
        np.asarray(lane_k, dtype=np.int32),
        np.asarray(a_len, dtype=np.int32),
        np.asarray(diag_lo, dtype=np.int32),
        np.asarray(diag_hi, dtype=np.int32),
    )
    if mesh is not None and mesh.size > 1:
        from jax.sharding import PartitionSpec as P

        from ..parallel.dp import stage_global

        specs = (P(None, "dp"), P("dp", None), P("dp"), P(), P("dp"),
                 P("dp"), P("dp"), P("dp"))
        args = tuple(stage_global(mesh, s, a) for s, a in zip(specs, host_args))
        return sharded_extend_v3(mesh, W, bound_diag)(*args)
    args = tuple(jnp.asarray(a) for a in host_args)
    return _extend_scan_v3(*args, W=W, bound_diag=bound_diag)


