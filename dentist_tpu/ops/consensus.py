"""Pile-up consensus: iterative realign-and-vote template refinement.

The daccord replacement (SURVEY §2.3: "windowed POA / consensus kernel").
daccord computes a reference-guided consensus from intra-pile-up
alignments with intrinsic QVs and an error profile; the equivalent here:

1. All cropped pile-up reads share one genomic interval and orientation
   (the cropper normalizes strand and anchors every read at a common
   trace point), so read↔template alignment needs no seeding — a banded
   free-shift NW with the band following the proportional diagonal.
2. The forward DP **and the traceback** run batched on device: lanes are
   (template, read) pairs drawn from MANY pile-ups at once, each lane
   carrying its own template stream — one dispatch per (template-length,
   read-length) bucket serves every pile-up in the batch
   (``processPileUps/package.d:146-159`` thread-parallelizes pile-ups;
   here they share device dispatches).  The traceback is a second
   ``lax.scan`` over path steps whose emitted (row, col, move) streams
   are scatter-reduced into dense per-lane alignment columns — the
   (N, T, W) move tensor never leaves the device.
3. Per-column voting and template rebuild are vectorized host passes
   over the compact per-lane column arrays; the new template is the
   per-column majority (base/deletion) plus majority-supported
   insertions.  2–3 rounds converge to the pile-up consensus (daccord's
   windowed alignment achieves the same fixpoint — the window structure
   is an implementation detail of its O(n·w) cost model).
4. Byproducts per read: per-trace-window diff counts = the intrinsic
   QV signal (``computeintrinsicqv`` equivalent) used for reference-read
   selection (``processPileUps/package.d:518-568``) and validation.
"""

from __future__ import annotations

import functools
import os
import time
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..models.alignments import TRACE_SPACING
from ..utils.log import log_json
from ..utils.prof import prof, prof_add

__all__ = ["ConsensusResult", "consensus", "consensus_batch",
           "rank_reference_reads"]

_INF = np.int32(1 << 28)
#: move codes
_DIAG, _UP, _LEFT, _NONE = 0, 1, 2, 3

#: template-length buckets: ~factor-1.5 steps in the example-scale range
#: (pile-up templates measured p50 ≈ 3.7 k, p90 ≈ 7 k — pure powers of 2
#: paid up to 2× padded scan rows AND fetch bytes on the dominant sizes)
_T_BUCKETS = [512, 1024, 2048, 3072, 4096, 6144, 8192, 12288, 16384, 32768]
#: device-memory budget for the (T, N, W) move tensor per dispatch
_MOVE_BUDGET = 1 << 28
#: lane-count ladder (factor 4, all multiples of the mesh size): the RL
#: axis is folded into T (reads dispatch at RL = 2·T always, see
#: :func:`_rl_bucket`) and lane counts quantize to this ladder, so a run
#: touches few (T, RL, N) compiled programs and retries reuse them
_N_LADDER = [32, 128, 512, 2048, 8192]


def _t_bucket(t: int) -> int:
    for b in _T_BUCKETS:
        if t <= b:
            return b
    return _T_BUCKETS[-1]


def _rl_bucket(rl: int, tb: int) -> int:
    """Read-length bucket: always 2·T (one compiled shape per T bucket).

    Reads longer than 2·T cannot produce acceptable lanes anyway — the
    free-shift DP must consume the whole read, costing ≥ RL − T edits —
    so such reads are dispatched on their 2·T prefix (gap pile-ups bound
    one-anchored reads well below this; extension templates never grow
    past ~the median read length)."""
    return 2 * tb


def _n_max(tb: int, W: int) -> int:
    """Main-chunk lane count for a T bucket (move-tensor budget)."""
    return max(_N_LADDER[0],
               1 << ((_MOVE_BUDGET // (tb * W)).bit_length() - 1))


def _is_accel() -> bool:
    import jax

    return jax.default_backend() != "cpu"


def _n_bucket_lanes(n: int, tb: int, W: int) -> int:
    """Pad a chunk's lane count to a compiled shape.

    On accelerators exactly TWO shapes exist per T bucket (32 or the
    move-budget width).  The rationale was the former remote backend,
    where every compiled program cost a per-process load over the link
    while padded lanes only cost device compute; the choice is
    unmeasured on the GPU.  On CPU (tests) the padded compute is real
    time, so the finer ladder stays.
    """
    cap = _n_max(tb, W)
    if _is_accel():
        return _N_LADDER[0] if n <= _N_LADDER[0] else cap
    for b in _N_LADDER:
        if n <= b <= cap:
            return b
    return cap


# ======================================================================
# Batched banded NW round: forward DP + device traceback
# ======================================================================


def _nw_round_parts(tpl, t_lens, reads, read_lens, centers,
                    T: int, W: int, S: int, NWIN: int,
                    lead_free: int = -1):
    """One realign round for N independent (template, read) lanes.

    tpl: (T, N) uint8 — per-lane template char stream (lanes of one
    pile-up share columns but the kernel doesn't care); t_lens (N,);
    reads (N, RL) uint8; read_lens (N,); centers (T+1, N) int32 band
    centers per template row.

    Free-shift semantics (matching the pile-up geometry): free leading
    read prefix and free leading/trailing template gap; the read must be
    fully consumed (free trailing-read ends would silence the trailing
    insertion votes that let extension templates grow).

    Returns per lane, all on device:
      sym (N, T) int8 — read contribution per template column
        (0..3 base, 4 deletion, 5 uncovered),
      ins (N, T+1, 4) int8 — up to 4 ranked insertions before each
        column (0 none, 1..4 base+1),
      jpath (N, T+1) int32 — read coordinate where each template
        boundary is crossed (−1 uncovered),
      spans (N, 2) int32 — covered template interval,
      diffs (N,) int32 — total edit distance,
      win (N, NWIN) int32 — per-126bp-window diffs (intrinsic QV signal),
      covered (N,) bool.
    """
    tpl = tpl.astype(jnp.int32)
    reads_i = reads.astype(jnp.int32)
    N, RL = reads_i.shape
    p = jnp.arange(W, dtype=jnp.int32)
    lane = jnp.arange(N, dtype=jnp.int32)
    rl_clip = jnp.maximum(read_lens - W // 2, 0)

    def off_from(c):
        return jnp.clip(c - W // 2, -W // 2, rl_clip)

    off0 = off_from(centers[0])
    j0g = off0[:, None] + p[None, :]
    # lead_free < 0: fully free leading read prefix (pile-up geometry —
    # reads may start anywhere).  lead_free ≥ 0: only that many leading
    # chars skip free, the rest cost 1 each — REQUIRED for short windowed
    # segments, where a fully free prefix lets the DP skip the whole
    # segment and "consume" it in one row (degenerate cost ≈ 0)
    d_init = 0 if lead_free < 0 else jnp.maximum(j0g - lead_free, 0)
    D0 = jnp.where((j0g >= 0) & (j0g <= read_lens[:, None]), d_init,
                   _INF).astype(jnp.int32)

    # Chunked scan: centers are step-clamped (≤2/row, `_clamp_steps`), so
    # band moves are 3-way static-shift selects and the (N, W + 2C) read
    # window refills with ONE gather per C rows — the previous per-row
    # take_along_axis triple (D×2 + read chars) was the stage's cost.
    C = 32
    assert T % C == 0, f"template bucket {T} must be a multiple of {C}"
    NC = T // C
    WB = W + 2 * C
    offs = off_from(centers)  # (T+1, N), steps in {0,1,2}
    s_all = offs[1:] - offs[:-1]
    tpl_cnk = tpl.reshape(NC, C, N)
    off_cnk = offs[1:].reshape(NC, C, N)
    s_cnk = s_all.reshape(NC, C, N)
    off_first = offs[1::C]  # (NC, N): offset at each chunk's first row
    rows0 = jnp.arange(1, T + 1, C, dtype=jnp.int32)
    pwb = jnp.arange(WB, dtype=jnp.int32)
    inf_col = jnp.full((N, 1), _INF, jnp.int32)

    def row_body(carry, xs):
        D_prev, buf = carry
        t_ch, off_row, s_row, i, shift_b = xs
        off = off_row[:, None]
        s = s_row[:, None]
        sh1 = jnp.concatenate([D_prev[:, 1:], inf_col], axis=1)
        sh2 = jnp.concatenate([D_prev[:, 2:], inf_col, inf_col], axis=1)
        E = jnp.where(s == 0, D_prev, jnp.where(s == 1, sh1, sh2))
        shm1 = jnp.concatenate([inf_col, D_prev[:, :-1]], axis=1)
        E1 = jnp.where(s == 0, shm1, jnp.where(s == 1, D_prev, sh1))

        sb = s * shift_b  # the refill already sits at the chunk's first row
        bb1 = jnp.concatenate([buf[:, 1:], buf[:, :1]], axis=1)
        bb2 = jnp.concatenate([buf[:, 2:], buf[:, :2]], axis=1)
        buf = jnp.where(sb == 0, buf, jnp.where(sb == 1, bb1, bb2))
        r_ch = buf[:, :W]

        j = off + p[None, :]
        sub = (r_ch != t_ch[:, None]).astype(jnp.int32)
        diag = jnp.where(j >= 1, E1 + sub, _INF)
        up = E + 1
        # free leading template gap: entering at j == 0 costs nothing
        up = jnp.where(j == 0, jnp.minimum(up, 0), up)
        tmp = jnp.minimum(diag, up)
        choose_up = up < diag  # strict: prefer diag on ties
        closed = jax.lax.associative_scan(jnp.minimum, tmp - p[None, :], axis=1)
        D = closed + p[None, :]
        from_left = D < tmp
        valid = (j >= 0) & (j <= read_lens[:, None]) & (i <= t_lens)[..., None]
        D = jnp.where(valid, jnp.minimum(D, _INF), _INF)
        move = jnp.where(from_left, _LEFT, jnp.where(choose_up, _UP, _DIAG))
        # bits 2-3 carry the read char, bit 4 the mismatch flag: the
        # traceback then needs no (S, N) gathers from reads/templates
        move = move | (r_ch << 2) | (sub << 4)
        move = jnp.where(valid, move, _NONE).astype(jnp.uint8)
        at_end = jnp.where((j == read_lens[:, None]) & valid, D, _INF).min(axis=1)
        return (D, buf), (move, at_end)

    shift_b = jnp.concatenate([jnp.zeros(1, jnp.int32),
                               jnp.ones(C - 1, jnp.int32)])

    def chunk_body(D_prev, xs):
        tpl_c, off_c, s_c, off_f, r0 = xs
        idx = jnp.clip(off_f[:, None] - 1 + pwb[None, :], 0, RL - 1)
        buf = jnp.take_along_axis(reads_i, idx, axis=1)  # (N, WB)
        rows_c = r0 + jnp.arange(C, dtype=jnp.int32)
        (D, _), ys = jax.lax.scan(
            row_body, (D_prev, buf), (tpl_c, off_c, s_c, rows_c, shift_b),
            unroll=2)
        return D, ys

    _, (moves, d_at_jend) = jax.lax.scan(
        chunk_body, D0, (tpl_cnk, off_cnk, s_cnk, off_first, rows0))
    moves = moves.reshape(T, N, W)
    d_at_jend = d_at_jend.reshape(T, N)
    # moves: (T, N, W) uint8 — stays on device

    # ---- end selection: best "read exhausted" row per lane
    dmin = d_at_jend.min(axis=0)
    best_i = jnp.argmin(d_at_jend, axis=0).astype(jnp.int32) + 1
    covered = dmin < _INF
    i0 = jnp.where(covered, best_i, 0)
    j_start = jnp.where(covered, read_lens, 0)

    # ---- traceback scan over path steps (i or j strictly decreases)
    moves_flat = moves.reshape(-1)
    centers_T = centers.T  # (N, T+1)

    def tb(carry, _):
        i, j, run, active = carry
        c_i = jnp.take_along_axis(centers_T, jnp.clip(i, 0, T)[:, None], axis=1)[:, 0]
        off = off_from(c_i)
        pp = j - off
        inb = (pp >= 0) & (pp < W) & (i >= 1)
        flat = (jnp.clip(i - 1, 0, T - 1) * N + lane) * W + jnp.clip(pp, 0, W - 1)
        mv_raw = jnp.where(active & inb, moves_flat[flat], _NONE).astype(jnp.int32)
        mv = mv_raw & 3
        is_d = mv == _DIAG
        is_u = mv == _UP
        is_l = mv == _LEFT
        i2 = i - (is_d | is_u)
        j2 = j - (is_d | is_l)
        run2 = jnp.where(is_l, run + 1, 0)
        active2 = active & (mv != _NONE) & (i2 > 0) & (j2 > 0)
        return (i2, j2, run2, active2), (i, j, mv_raw, run)

    zero = jnp.zeros_like(lane)
    init = (i0, j_start, zero, covered & (i0 > 0) & (j_start > 0))
    (i_f, _, _, _), (I, J, MV_RAW, RUN) = jax.lax.scan(tb, init, None, length=S)

    # ---- scatter path steps into dense per-lane column arrays
    lane2 = jnp.broadcast_to(lane[None, :], (S, N))
    MV = MV_RAW & 3
    base = (MV_RAW >> 2) & 3  # read char, embedded in the move code
    diag_or_up = (MV == _DIAG) | (MV == _UP)
    is_left = MV == _LEFT

    sym0 = jnp.full((N, T + 1), 5, jnp.int8)
    symval = jnp.where(MV == _DIAG, base, 4).astype(jnp.int8)
    sym0 = sym0.at[lane2, jnp.where(diag_or_up, jnp.clip(I - 1, 0, T - 1), T)].min(
        jnp.where(diag_or_up, symval, 127).astype(jnp.int8))
    sym = sym0[:, :T]

    ins_ok = is_left & (RUN < 4)
    ins0 = jnp.zeros((N, T + 2, 4), jnp.int8)
    ins0 = ins0.at[lane2, jnp.where(ins_ok, jnp.clip(I, 0, T), T + 1),
                   jnp.where(ins_ok, RUN, 0)].max(
        jnp.where(ins_ok, (base + 1).astype(jnp.int8), 0))
    ins = ins0[:, : T + 1]

    jp0 = jnp.full((N, T + 2), -1, jnp.int32)
    jp0 = jp0.at[lane, jnp.clip(i0, 0, T)].max(jnp.where(covered, j_start, -1))
    jp0 = jp0.at[lane2, jnp.where(diag_or_up, jnp.clip(I - 1, 0, T), T + 1)].max(
        jnp.where(diag_or_up, J - (MV == _DIAG), -1))
    jpath = jp0[:, : T + 1]

    mism = (MV == _DIAG) & (((MV_RAW >> 4) & 1) == 1)  # embedded sub flag
    contrib = mism | (MV == _UP) | is_left
    w = jnp.where(is_left, jnp.minimum(I, t_lens[lane2] - 1), I - 1) // TRACE_SPACING
    win0 = jnp.zeros((N, NWIN + 1), jnp.int32)
    win0 = win0.at[lane2, jnp.where(contrib, jnp.clip(w, 0, NWIN - 1), NWIN)].add(
        contrib.astype(jnp.int32))
    win = win0[:, :NWIN]

    spans = jnp.stack([jnp.where(covered, i_f, 0), jnp.where(covered, i0, 0)], axis=1)
    diffs = jnp.where(covered, dmin, 0)
    return sym, ins, jpath, spans, diffs, win, covered


@functools.partial(jax.jit, static_argnames=("T", "W", "S", "NWIN",
                                             "lead_free"))
def _nw_round_kernel(tpl, t_lens, reads, read_lens, centers,
                     T: int, W: int, S: int, NWIN: int,
                     lead_free: int = -1):
    """:func:`_nw_round_parts` with the results packed into ONE block:
    one device-to-host copy per dispatch instead of seven, and ~half the
    bytes of the unpacked ~9·T bytes/lane.  Packing:
    sym 2 cols/byte (values 0..5), the 4 ins slots 3 bits each in one
    u16/boundary, jpath as int16 relative to the band center (in-band by
    construction, |j − c| ≤ W; −32768 = uncovered) — ~4.6·T bytes/lane.
    """
    sym, ins, jpath, spans, diffs, win, covered = _nw_round_parts(
        tpl, t_lens, reads, read_lens, centers, T=T, W=W, S=S, NWIN=NWIN,
        lead_free=lead_free)
    N = sym.shape[0]
    sym_u = sym.astype(jnp.uint8)
    sym_nib = (sym_u[:, 0::2] << 4) | sym_u[:, 1::2]  # (N, T/2)
    ins_u = ins.astype(jnp.uint16)
    ins16 = (ins_u[:, :, 0] | (ins_u[:, :, 1] << 3)
             | (ins_u[:, :, 2] << 6) | (ins_u[:, :, 3] << 9))  # (N, T+1)
    ins16 = jnp.concatenate([ins16, jnp.zeros((N, 1), jnp.uint16)], axis=1)
    jrel = jnp.where(jpath >= 0, jpath - centers.T.astype(jnp.int32),
                     -32768).astype(jnp.int16)
    jrel = jnp.concatenate([jrel, jnp.full((N, 1), -32768, jnp.int16)], axis=1)
    w_sym = jax.lax.bitcast_convert_type(
        sym_nib.reshape(N, T // 8, 4), jnp.int32)
    w_ins = jax.lax.bitcast_convert_type(
        ins16.reshape(N, (T + 2) // 2, 2), jnp.int32)
    w_j = jax.lax.bitcast_convert_type(
        jrel.reshape(N, (T + 2) // 2, 2), jnp.int32)
    return jnp.concatenate(
        [w_sym, w_ins, w_j, spans, diffs[:, None], win,
         covered.astype(jnp.int32)[:, None]], axis=1)


#: sparse-block caps: events beyond these flip the lane's overflow flag
#: and it is re-fetched through the dense kernel (error rates would have
#: to exceed ~19 % mismatch+del or ~19 % insertion-boundary density —
#: far past the pile-up reads' ~13 % total error)
_CAP_E = 16  # jpath delta escapes (>14 read chars across one boundary)


def _sparse_caps(T: int) -> tuple[int, int]:
    return 3 * T // 16, 3 * T // 16  # (sym events, ins-boundary events)


def _sparse_words(T: int, NWIN: int) -> int:
    """int32 words per lane of the sparse result block."""
    nbytes = (T // 2 + 2 * _CAP_E + T // 8 + 3 * T // 64 + (T // 8 + 4)
              + 2 * (3 * T // 16))
    return nbytes // 4 + 6 + NWIN


def _packbits_dev(m):
    """(N, X) bool, X % 8 == 0 → (N, X//8) u8; bit k of byte i = col 8i+k
    (numpy ``unpackbits(bitorder="little")`` order)."""
    N, X = m.shape
    b = m.reshape(N, X // 8, 8).astype(jnp.int32)
    w = (b << jnp.arange(8, dtype=jnp.int32)[None, None, :]).sum(axis=2)
    return w.astype(jnp.uint8)


def _scatter_events(ev, payload, cap: int, dtype):
    """Compact per-lane events (left-to-right) into ``(N, cap)`` slots.

    Returns ``(slots, count)``; events past ``cap`` are dropped (the
    caller checks ``count > cap`` for overflow)."""
    N = ev.shape[0]
    idx = jnp.cumsum(ev.astype(jnp.int32), axis=1) - 1
    dst = jnp.where(ev & (idx < cap), idx, cap)
    slots = jnp.zeros((N, cap + 1), dtype).at[
        jnp.arange(N)[:, None], dst].max(jnp.where(ev, payload, 0).astype(dtype))
    count = jnp.where(ev.any(axis=1), idx[:, -1] + 1, 0)
    return slots[:, :cap], count


@functools.partial(jax.jit, static_argnames=("T", "RL", "W", "S", "NWIN",
                                             "lead_free"))
def _nw_round_packed_sparse(chars_pack, meta, T: int, RL: int, W: int, S: int,
                            NWIN: int, lead_free: int = -1):
    """:func:`_nw_round_packed` with a SPARSE result block.

    The dense block copies ~4.6·T bytes/lane to the host; at ~13 % read
    error its information content is ~10× lower.  This
    variant emits, per lane:

    - ``jpath`` as 4-bit deltas over the covered boundary range (+ a
      u16 escape list for deltas > 14) — exact reconstruction from
      ``jp_base`` by prefix sum;
    - sym as a divergence **bitmask** vs the template (covered columns
      equal the template unless flagged) + 2-bit codes ranking the
      event value among the 4 non-template symbols;
    - insertions as a boundary bitmask + the 12-bit slot pack per
      flagged boundary;
    - the usual spans/diffs/win/covered plus an overflow flag.

    ~1.2·T bytes/lane; the host decoder rebuilds the EXACT dense arrays
    (``_collect_chunk_sparse``), so downstream voting/polish logic is
    byte-identical.  Lanes whose event counts exceed the caps are
    re-fetched through the dense kernel by the round executor.
    """
    from .banded import _unpack2bit

    N = meta.shape[0] // 3
    TP, RP = T // 4, RL // 4
    tpl = _unpack2bit(chars_pack[:, :TP]).T  # (T, N)
    reads = _unpack2bit(chars_pack[:, TP : TP + RP])
    steps = _unpack2bit(chars_pack[:, TP + RP :]).T.astype(jnp.int32)
    t_lens = meta[:N]
    read_lens = meta[N : 2 * N]
    c0 = meta[2 * N :]
    centers = jnp.concatenate(
        [c0[None, :], c0[None, :] + jnp.cumsum(steps, axis=0)], axis=0)
    sym, ins, jpath, spans, diffs, win, covered = _nw_round_parts(
        tpl, t_lens, reads, read_lens, centers, T=T, W=W, S=S, NWIN=NWIN,
        lead_free=lead_free)

    CAP_S, CAP_I = _sparse_caps(T)
    lanesc = jnp.arange(N)
    colr = jnp.arange(T, dtype=jnp.int32)[None, :]
    s0 = spans[:, 0].astype(jnp.int32)
    s1 = spans[:, 1].astype(jnp.int32)
    in_span = (colr >= s0[:, None]) & (colr < s1[:, None]) & covered[:, None]
    tplT = tpl.T.astype(jnp.int8)  # (N, T)

    # ---- sym divergence events
    ev = in_span & (sym != tplT)
    code = (sym - (sym > tplT)).astype(jnp.int32)  # rank among non-tpl values
    codes, sym_cnt = _scatter_events(ev, code, CAP_S, jnp.uint8)
    sym_mask = _packbits_dev(ev)  # (N, T//8)
    c4 = codes.reshape(N, CAP_S // 4, 4).astype(jnp.int32)
    sym_codes = (c4[:, :, 0] | (c4[:, :, 1] << 2) | (c4[:, :, 2] << 4)
                 | (c4[:, :, 3] << 6)).astype(jnp.uint8)

    # ---- insertion-boundary events (12-bit slot pack per boundary)
    ins_u = ins.astype(jnp.uint16)
    ins16 = (ins_u[:, :, 0] | (ins_u[:, :, 1] << 3)
             | (ins_u[:, :, 2] << 6) | (ins_u[:, :, 3] << 9))  # (N, T+1)
    iev = ins16 != 0
    ivals, ins_cnt = _scatter_events(iev, ins16.astype(jnp.int32), CAP_I,
                                     jnp.uint16)
    iev_pad = jnp.concatenate(
        [iev, jnp.zeros((N, 31), bool)], axis=1)[:, : T + 32]
    ins_mask = _packbits_dev(iev_pad)  # (N, T//8 + 4)

    # ---- jpath deltas (4-bit + escapes)
    d = (jpath[:, 1:] - jpath[:, :-1]).astype(jnp.int32)  # (N, T)
    jd_in = in_span  # boundary c→c+1 valid iff col c in the covered span
    d = jnp.where(jd_in, d, 0)
    esc = d > 14
    nib = jnp.where(esc, 15, d).astype(jnp.int32)
    jp_nib = (nib[:, 0::2] | (nib[:, 1::2] << 4)).astype(jnp.uint8)
    evals, esc_cnt = _scatter_events(esc, jnp.clip(d, 0, 65535), _CAP_E,
                                     jnp.uint16)
    jp_base = jnp.take_along_axis(
        jpath, jnp.clip(s0, 0, T)[:, None], axis=1)[:, 0].astype(jnp.int32)

    ovf = (sym_cnt > CAP_S) | (ins_cnt > CAP_I) | (esc_cnt > _CAP_E)
    misc = jnp.stack([jp_base, s0, s1, diffs.astype(jnp.int32),
                      covered.astype(jnp.int32), ovf.astype(jnp.int32)],
                     axis=1)
    esc_b = jax.lax.bitcast_convert_type(evals, jnp.uint8).reshape(N, -1)
    ivals_b = jax.lax.bitcast_convert_type(ivals, jnp.uint8).reshape(N, -1)
    buf8 = jnp.concatenate(
        [jp_nib, esc_b, sym_mask, sym_codes, ins_mask, ivals_b], axis=1)
    words = jax.lax.bitcast_convert_type(
        buf8.reshape(N, buf8.shape[1] // 4, 4), jnp.int32)
    return jnp.concatenate([words, misc, win.astype(jnp.int32)], axis=1)


@functools.partial(jax.jit, static_argnames=("T", "RL", "W", "S", "NWIN",
                                             "lead_free"))
def _nw_round_packed(chars_pack, meta, T: int, RL: int, W: int, S: int,
                     NWIN: int, lead_free: int = -1):
    """:func:`_nw_round_kernel` fed from TWO transfers instead of five.

    ``chars_pack`` (N, T/4 + RL/4 + T/4) uint8 = [template 2-bit packed |
    read 2-bit packed | band-center steps 2-bit packed]; ``meta``
    (3N,) int32 = [t_lens | read_lens | centers_row0].  Band centers are
    step-clamped to {0, 1, 2} per row (``_clamp_steps``), so they travel
    as 2-bit steps and are rebuilt with one cumsum.
    """
    from .banded import _unpack2bit

    N = meta.shape[0] // 3
    TP, RP = T // 4, RL // 4
    tpl = _unpack2bit(chars_pack[:, :TP]).T  # (T, N)
    reads = _unpack2bit(chars_pack[:, TP : TP + RP])  # (N, RL)
    steps = _unpack2bit(chars_pack[:, TP + RP :]).T.astype(jnp.int32)  # (T, N)
    t_lens = meta[:N]
    read_lens = meta[N : 2 * N]
    c0 = meta[2 * N :]
    centers = jnp.concatenate(
        [c0[None, :], c0[None, :] + jnp.cumsum(steps, axis=0)], axis=0)
    return _nw_round_kernel(tpl, t_lens, reads, read_lens, centers,
                            T=T, W=W, S=S, NWIN=NWIN, lead_free=lead_free)


# ======================================================================
# Host round executor: bucket + dispatch lanes from many pile-ups
# ======================================================================


@dataclass
class _RoundOut:
    """Per-job results of one realign round (host arrays)."""

    sym: np.ndarray  # (n, T) int8
    ins: np.ndarray  # (n, T+1, 4) int8
    jpath: np.ndarray  # (n, T+1) int64
    spans: np.ndarray  # (n, 2)
    diffs: np.ndarray  # (n,)
    win: np.ndarray  # (n, NWIN)
    covered: np.ndarray  # (n,) bool
    #: columns whose values were (re)aligned this round; None = all of
    #: them (full rounds).  Incremental rounds carry forward the stale
    #: columns from ``prev`` and mark only realigned window interiors.
    fresh_cols: np.ndarray | None = None  # (T,) bool
    fresh_bnds: np.ndarray | None = None  # (T+1,) bool


@dataclass
class _ConsJob:
    """One pile-up's realign-round input.

    ``dirty`` (len-T bool, only with ``prev``) restricts realignment to
    windows touching dirty columns — the incremental rounds that make
    template-edit iteration O(edits), not O(template): clean windows
    keep ``prev``'s stitched values (their template columns are
    unchanged, so the old per-read contributions are still exact).
    """

    template: np.ndarray
    reads: list[np.ndarray]
    jpath: np.ndarray | None = None
    prev: _RoundOut | None = None
    dirty: np.ndarray | None = None
    reads_arr: np.ndarray | None = None  # (n, RL) uint8 cache
    #: device-resident flat cropped-read store + this job's per-read
    #: offsets into it (enables metadata-only windowed dispatches)
    seg_res: object = None
    read_offs: np.ndarray | None = None

    def reads_u8(self) -> np.ndarray:
        if self.reads_arr is None:
            RL = max((len(r) for r in self.reads), default=1)
            arr = np.zeros((len(self.reads), RL), dtype=np.uint8)
            for ni, r in enumerate(self.reads):
                arr[ni, : len(r)] = r
            self.reads_arr = arr
        return self.reads_arr


class _ArenaRef:
    """A store uploaded to the device arena, re-uploaded transparently
    if the arena was reset (epoch change) since."""

    def __init__(self, codes: np.ndarray):
        from .banded import ARENA

        self.codes = codes
        self.base = ARENA.offset_of(codes, cache=False)
        self.epoch = ARENA.epoch

    def offset(self) -> int:
        from .banded import ARENA

        if ARENA.epoch != self.epoch:
            self.base = ARENA.offset_of(self.codes, cache=False)
            self.epoch = ARENA.epoch
        return self.base


def _as_jobs(jobs) -> "list[_ConsJob]":
    return [j if isinstance(j, _ConsJob) else _ConsJob(*j) for j in jobs]


def _dilate_mask(mask: np.ndarray, pad: int) -> np.ndarray:
    """Dilate a bool mask by ``pad`` positions on each side."""
    if not mask.any():
        return mask
    idx = np.flatnonzero(mask)
    out = np.zeros(len(mask) + 1, dtype=np.int32)
    lo = np.maximum(idx - pad, 0)
    hi = np.minimum(idx + pad + 1, len(mask))
    np.add.at(out, lo, 1)
    np.add.at(out, hi, -1)
    return np.cumsum(out[:-1]) > 0


def _clamp_steps(centers: np.ndarray) -> np.ndarray:
    """Limit per-row center increments to ≤ 2: ``c'_i = min_{k≤i}(c_k +
    2(i−k))``.  Bounded shifts let the kernel realize band moves as
    static shift selects instead of per-row gathers; a band that cannot
    keep up (read ≫ 2×template) simply fails coverage and is retried /
    dropped, as before."""
    rows2 = 2 * np.arange(centers.shape[0], dtype=np.int64)[:, None]
    return (np.minimum.accumulate(centers.astype(np.int64) - rows2, axis=0)
            + rows2).astype(np.int32)


def _make_centers(T: int, read_lens: np.ndarray, jpath: np.ndarray | None) -> np.ndarray:
    """Band centers (T+1, N): slope-1 clamped, or previous traceback path."""
    N = len(read_lens)
    rows = np.arange(T + 1, dtype=np.int64)
    centers = np.minimum(rows[:, None], read_lens[None, :].astype(np.int64))
    if jpath is not None and jpath.shape[0] == N:
        Tp = jpath.shape[1] - 1
        for n in range(N):
            good = np.flatnonzero(jpath[n] >= 0)
            if len(good) >= 2:
                interp = np.interp(
                    np.linspace(0, Tp, T + 1), good, jpath[n, good]
                )
                centers[:, n] = np.clip(np.round(interp), 0, read_lens[n]).astype(np.int64)
    return _clamp_steps(centers.astype(np.int32))


def _prop_centers(T: int, read_lens: np.ndarray) -> np.ndarray:
    rows = np.arange(T + 1, dtype=np.int64)
    prop = np.minimum(
        rows[:, None] * read_lens[None, :].astype(np.int64) // max(T, 1),
        read_lens[None, :].astype(np.int64),
    )
    return _clamp_steps(prop.astype(np.int32))


def _run_round(jobs, W: int, mesh=None) -> list[_RoundOut]:
    """One realign round for every job, routed per lane.

    Lanes whose previous-round traceback path is available (``jpath``
    row with ≥ 2 valid boundaries) realign through the WINDOWED kernel —
    independent ``_WS``-column template windows anchored on the previous
    path, all windows of all lanes of all jobs in one fixed-shape
    dispatch (daccord's windowed consensus re-expressed for a batched
    device: the full-template scan is latency-bound at one sequential row per
    template column, the windowed realign runs thousands of 192-row DPs
    in parallel).  First-round lanes (no path yet) and windowed failures
    take the full banded scan (:func:`_run_round_full`).
    """
    jobs = _as_jobs(jobs)
    if os.environ.get("DENTIST_TPU_NO_WINDOWED"):
        return _run_round_full(jobs, W, mesh=mesh)
    win_jobs: list[int] = []
    full_jobs: list[int] = []
    for ji, job in enumerate(jobs):
        if (job.jpath is not None
                and job.jpath.shape == (len(job.reads), len(job.template) + 1)
                and len(job.template) >= _WS):
            win_jobs.append(ji)
        else:
            full_jobs.append(ji)
    outs: list[_RoundOut | None] = [None] * len(jobs)
    retry_jobs: list[_ConsJob] = []
    retry_map: list[tuple[int, int]] = []  # (job_idx, read_idx)
    if win_jobs:
        wouts, failures = _run_round_windowed([jobs[ji] for ji in win_jobs],
                                              W, mesh=mesh)
        for wi, ji in enumerate(win_jobs):
            outs[ji] = wouts[wi]
        for wi, ri in failures:
            ji = win_jobs[wi]
            retry_jobs.append(_ConsJob(jobs[ji].template, [jobs[ji].reads[ri]]))
            retry_map.append((ji, ri))
    if full_jobs or retry_jobs:
        fouts = _run_round_full([jobs[ji] for ji in full_jobs] + retry_jobs,
                                W, mesh=mesh)
        for k, ji in enumerate(full_jobs):
            outs[ji] = fouts[k]
        for k, (ji, ri) in enumerate(retry_map):
            r = fouts[len(full_jobs) + k]
            o = outs[ji]
            o.sym[ri] = r.sym[0]
            o.ins[ri] = r.ins[0]
            o.jpath[ri] = r.jpath[0]
            o.spans[ri] = r.spans[0]
            o.diffs[ri] = r.diffs[0]
            o.win[ri] = r.win[0][: o.win.shape[1]]
            o.covered[ri] = r.covered[0]
    return outs


def _run_round_full(jobs, W: int, mesh=None) -> list[_RoundOut]:
    """Align every job's reads to its template in bucketed batched
    dispatches; lanes from all jobs share dispatches.

    Lanes that fail with path-following/slope-1 centers are retried once
    with proportional centers (partial vs full-span reads drift
    differently).  With ``mesh`` (>1 device) every dispatch runs
    data-parallel over the mesh's ``dp`` axis with allgathered outputs
    (identical results).
    """
    from concurrent.futures import ThreadPoolExecutor

    jobs = _as_jobs(jobs)
    lanes = []  # (job_idx, read_idx, template, read)
    # band centers are built ONCE per job across all its lanes (the
    # per-lane np.interp calls were a measured host hotspot)
    centers_path: list[np.ndarray] = []
    centers_prop: list[np.ndarray | None] = []
    for ji, job in enumerate(jobs):
        template, reads, jpath_prev = job.template, job.reads, job.jpath
        T = max(len(template), 1)
        rl = np.array([len(r) for r in reads], dtype=np.int64)
        jp = jpath_prev if (jpath_prev is not None
                            and jpath_prev.shape[0] == len(reads)) else None
        centers_path.append(_make_centers(T, rl, jp))
        centers_prop.append(None)  # built lazily on retry
        for ri, r in enumerate(reads):
            lanes.append((ji, ri, template, r))

    outs: dict[tuple[int, int], tuple] = {}
    groups: dict[int, list[int]] = {}  # T bucket -> lane indices
    for li, (ji, ri, template, r) in enumerate(lanes):
        groups.setdefault(_t_bucket(max(len(template), 1)), []).append(li)

    # two-phase: dispatch every chunk of every group before fetching any
    # result, so device compute overlaps host window assembly and the
    # per-dispatch round trips of different groups overlap each other.
    # Dispatch itself runs on a pool: first-call compiles (or cache
    # loads) of different shapes then overlap instead of serializing.
    def centers_for(li):
        ji, ri, _, _ = lanes[li]
        return centers_path[ji][:, ri]

    plan = []
    for TB, lidx in groups.items():
        max_n = _n_max(TB, W)
        for c0 in range(0, len(lidx), max_n):
            chunk = lidx[c0 : c0 + max_n]
            plan.append((chunk, TB))
    from ..parallel.dp import dispatch_workers

    use_sparse = not os.environ.get("DENTIST_TPU_DENSE_CONS")

    def collect(chunk, TB, arr, cen, only_if_better=False,
                centers_fn=None):
        """Sparse decode with dense refetch of cap-overflow lanes (the
        dense block is exact for any event density; ``centers_fn`` must
        be the SAME band-center source the decoded dispatch used)."""
        if not use_sparse:
            _collect_chunk(lanes, chunk, TB, outs,
                           only_if_better=only_if_better, fetched=arr,
                           centers=cen)
            return
        ovf = _collect_chunk_sparse(lanes, chunk, TB, outs,
                                    only_if_better=only_if_better,
                                    fetched=arr)
        if ovf:
            prof_add("cons.full.ovf_refetch", hits=len(ovf))
            ovf_lanes = [chunk[k] for k in ovf]
            h2, cen2 = _dispatch_chunk(lanes, ovf_lanes, TB, W,
                                       centers_fn or centers_for,
                                       mesh=mesh, dense=True)
            _collect_chunk(lanes, ovf_lanes, TB, outs,
                           only_if_better=only_if_better,
                           fetched=np.asarray(h2), centers=cen2)

    with prof("cons.full.dispatch"):
        with ThreadPoolExecutor(max_workers=dispatch_workers(4)) as ex:
            # multi-process meshes serialize launches (dispatch_workers=1):
            # every process must enqueue the collectives in the same order
            handles = list(ex.map(
                lambda t: _dispatch_chunk(lanes, t[0], t[1], W, centers_for,
                                          mesh=mesh, dense=not use_sparse),
                plan))
    with prof("cons.full.fetch"):
        with ThreadPoolExecutor(max_workers=4) as ex:
            # fetch all chunks concurrently: each fetch waits for its own
            # dispatch, and they pipeline when overlapped (fetches read
            # local shards only — no collective, any order)
            fetched = list(ex.map(lambda h: np.asarray(h[0]), handles))
    prof_add("cons.full.fetch", nbytes=sum(a.nbytes for a in fetched), hits=0)
    # decode chunks on a pool (numpy releases the GIL in the big
    # unpack/cumsum passes; serial decode was ~1.7 s/chunk at scale).
    # Multi-process meshes serialize (collect's overflow refetch
    # dispatches collectives, which must enqueue in one order per
    # process — see parallel.dp.dispatch_workers)
    with prof("cons.full.collect"):
        with ThreadPoolExecutor(max_workers=dispatch_workers(4)) as ex:
            list(ex.map(
                lambda t: collect(t[0][0], t[0][1], t[2], t[1][1]),
                zip(plan, handles, fetched)))
    retries = []
    for (chunk, TB), (_, cen), arr in zip(plan, handles, fetched):
        # retry uncovered lanes with proportional centers
        retry = [li for li in chunk if not outs[(lanes[li][0], lanes[li][1])][6]]
        if retry:
            for li in retry:
                ji = lanes[li][0]
                if centers_prop[ji] is None:
                    job = jobs[ji]
                    rl = np.array([len(r) for r in job.reads], dtype=np.int64)
                    centers_prop[ji] = _prop_centers(
                        max(len(job.template), 1), rl)

            def prop_for(li):
                ji, ri, _, _ = lanes[li]
                return centers_prop[ji][:, ri]

            retries.append((retry, TB,
                            _dispatch_chunk(lanes, retry, TB, W, prop_for,
                                            mesh=mesh,
                                            dense=not use_sparse), prop_for))
    with ThreadPoolExecutor(max_workers=4) as ex:
        refetched = list(ex.map(lambda t: np.asarray(t[2][0]), retries))
    for (retry, TB, (_, cen), pf), arr in zip(retries, refetched):
        collect(retry, TB, arr, cen, only_if_better=True, centers_fn=pf)

    # assemble per-job outputs
    with prof("cons.full.assemble"):
        results = []
        for ji, job in enumerate(jobs):
            T = len(job.template)
            n = len(job.reads)
            NWIN = max((TB_nwin(T)), 1)
            sym = np.full((n, T), 5, np.int8)
            ins = np.zeros((n, T + 1, 4), np.int8)
            jpath = np.full((n, T + 1), -1, np.int64)
            spans = np.zeros((n, 2), np.int64)
            diffs = np.zeros(n, np.int64)
            win = np.zeros((n, NWIN), np.int32)
            cov = np.zeros(n, bool)
            for ri in range(n):
                o = outs[(ji, ri)]
                sym[ri] = o[0][:T]
                ins[ri] = o[1][: T + 1]
                jpath[ri] = o[2][: T + 1]
                spans[ri] = o[3]
                diffs[ri] = o[4]
                win[ri] = o[5][:NWIN]
                cov[ri] = o[6]
            results.append(_RoundOut(sym, ins, jpath, spans, diffs, win, cov))
    return results


def TB_nwin(T: int) -> int:
    return (T + TRACE_SPACING - 1) // TRACE_SPACING


# ======================================================================
# Windowed realign round (rounds with a previous traceback path)
# ======================================================================

#: interior columns per window lane (= the QV/trace spacing, so stitched
#: per-window diff buckets land exactly on the intrinsic-QV grid)
_ADV = TRACE_SPACING
#: margin columns on each side of the interior, realigned but discarded —
#: absorbs boundary wander of the previous round's path (and of template
#: edits, which the exact ``src_bnd`` remap bounds to ±1 column per edit)
_MARGIN = 33
#: template rows per window lane (multiple of the kernel's 32-row chunks)
_WS = _ADV + 2 * _MARGIN
#: read-segment capacity per lane (the fixed RL bucket: 2·_WS)
_SEG = 2 * _WS
#: skippable read chars prepended before each window (leading read
#: prefixes are free in the kernel; trailing slack would be force-consumed)
_LEAD_SLACK = 8


#: windowed-lane result row: 64 B nibble-packed interior sym (126 cols)
#: + 254 B uint16-packed ins slots (127 boundaries) + 128 B band-relative
#: uint8 jpath (j − center + 64 ∈ [0, 192] since the band is W=128 wide;
#: 255 = uncovered) — fetch bytes are the windowed rounds' wall
_WROW = (64 + 2 * (_ADV + 1) + (_ADV + 1) + 3) // 4  # int32 words (112)


@functools.partial(jax.jit, static_argnames=("W",))
def _nw_window_round(chars_pack, meta, W: int):
    """Windowed realign dispatch: :func:`_nw_round_parts` at the fixed
    window shape, plus ON-DEVICE interior extraction and packing.

    Only each lane's interior ``_ADV`` columns matter for the stitch, so
    the kernel gathers them (offset ``loc0`` per lane) and
    packs: sym 2 cols/byte, the 4 ins slots into one uint16, jpath as
    int16 relative to the segment start — 572 B/lane instead of 1.76 kB.

    ``meta`` is (4, N) int32 = [t_lens; seg_lens; centers_row0; loc0].
    Returns (N, ``_WROW``) int32.
    """
    from .banded import _unpack2bit

    assert W <= 128, "byte-packed jpath offsets require the W=128 band"
    TP, RP = _WS // 4, _SEG // 4
    tpl = _unpack2bit(chars_pack[:, :TP]).T
    reads = _unpack2bit(chars_pack[:, TP : TP + RP])
    steps = _unpack2bit(chars_pack[:, TP + RP :]).T.astype(jnp.int32)
    t_lens, seg_lens, c0, loc0 = meta[0], meta[1], meta[2], meta[3]
    centers = jnp.concatenate(
        [c0[None, :], c0[None, :] + jnp.cumsum(steps, axis=0)], axis=0)
    return _window_dense_pack(tpl, reads, t_lens, seg_lens, centers, loc0, W)


def _window_dense_pack(tpl, reads, t_lens, seg_lens, centers, loc0, W):
    """Shared core: window DP + the DENSE interior row (448 B/lane)."""
    N = reads.shape[0]
    sym, ins, jpath, _, _, _, _ = _nw_round_parts(
        tpl, t_lens, reads, seg_lens, centers,
        T=_WS, W=W, S=_WS + _SEG, NWIN=max(TB_nwin(_WS), 1),
        lead_free=2 * _LEAD_SLACK)
    idx_c = loc0[:, None] + jnp.arange(_ADV, dtype=jnp.int32)[None, :]
    idx_b = loc0[:, None] + jnp.arange(_ADV + 1, dtype=jnp.int32)[None, :]
    sym_i = jnp.take_along_axis(sym, idx_c, axis=1).astype(jnp.uint8)
    ins_i = jnp.take_along_axis(ins, idx_b[:, :, None], axis=1).astype(jnp.uint16)
    jp_i = jnp.take_along_axis(jpath, idx_b, axis=1)
    # jpath relative to the band center at each boundary: in-band by
    # construction (|j − c| ≤ W ≤ 128), so one biased byte suffices
    cen_i = jnp.take_along_axis(centers.T, idx_b, axis=1)
    jp_b = jnp.where(jp_i >= 0,
                     jnp.clip(jp_i - cen_i + 64, 0, 254),
                     255).astype(jnp.uint8)
    jp_b = jnp.concatenate(
        [jp_b, jnp.full((N, 1), 255, jnp.uint8)], axis=1)  # pad to 128
    sym_p = ((sym_i[:, 0::2] << 4) | sym_i[:, 1::2]).astype(jnp.uint8)  # 63 B
    sym_p = jnp.concatenate(
        [sym_p, jnp.zeros((N, 1), jnp.uint8)], axis=1)  # pad to 64
    ins_p = (ins_i[:, :, 0] | (ins_i[:, :, 1] << 3)
             | (ins_i[:, :, 2] << 6) | (ins_i[:, :, 3] << 9))  # (N, 127) u16
    ins_b = jax.lax.bitcast_convert_type(ins_p, jnp.uint8).reshape(N, -1)
    buf = jnp.concatenate(
        [sym_p, ins_b, jp_b, jnp.zeros((N, 2), jnp.uint8)], axis=1)  # 448 B
    return jax.lax.bitcast_convert_type(buf.reshape(N, _WROW, 4), jnp.int32)


def _window_resident_inputs(arena, meta):
    """Build (tpl, reads, t_lens, seg_lens, centers, loc0) from the
    device arena + per-lane coordinates (see
    :func:`_nw_window_round_resident`)."""
    t_lens, seg_lens, loc0, tpl_start, seg_start = (
        meta[0], meta[1], meta[2], meta[3], meta[4])
    N = meta.shape[1]
    tpl_rows = jax.vmap(
        lambda s: jax.lax.dynamic_slice(arena, (s,), (_WS,)))(tpl_start)
    colw = jnp.arange(_WS, dtype=jnp.int32)[None, :]
    tpl_rows = jnp.where(colw < t_lens[:, None], tpl_rows, 0)
    seg_rows = jax.vmap(
        lambda s: jax.lax.dynamic_slice(arena, (s,), (_SEG,)))(seg_start)
    cols = jnp.arange(_SEG, dtype=jnp.int32)[None, :]
    seg_rows = jnp.where(cols < seg_lens[:, None], seg_rows, 0)
    # proportional centers, exactly as the host dispatch computes them
    rows = jnp.arange(_WS + 1, dtype=jnp.int32)[None, :]
    tl = jnp.maximum(t_lens, 1)[:, None]
    cen = (jnp.minimum(rows, tl) * seg_lens[:, None]) // tl
    steps = jnp.clip(cen[:, 1:] - cen[:, :-1], 0, 2)
    centers = jnp.concatenate(
        [jnp.zeros((N, 1), jnp.int32),
         jnp.cumsum(steps, axis=1)], axis=1).T  # (_WS+1, N), row0 = 0
    return tpl_rows.T, seg_rows, t_lens, seg_lens, centers, loc0


@functools.partial(jax.jit, static_argnames=("W",))
def _nw_window_round_resident_dense(arena, meta, W: int):
    """Dense-row variant of :func:`_nw_window_round_resident` (overflow
    refetches in resident mode)."""
    assert W <= 128
    return _window_dense_pack(*_window_resident_inputs(arena, meta), W)


#: sparse windowed-row caps (events per 126-col interior; means at 13 %
#: read error are ~8 mismatch/del and ~9 insertion boundaries)
_WCAP_S, _WCAP_I, _WCAP_E = 32, 24, 4
#: sparse windowed row: 42 int32 words (168 B) vs the dense 448 B
_WROW_SPARSE = 42


@functools.partial(jax.jit, static_argnames=("W",))
def _nw_window_round_sparse(chars_pack, meta, W: int):
    """:func:`_nw_window_round` with a SPARSE interior row (168 B/lane):
    jpath as 4-bit deltas (+escapes) from a u16 base, sym as a
    divergence bitmask + 2-bit codes, insertions as a boundary bitmask +
    12-bit slot packs.  Decoded exactly on the host; cap-overflow lanes
    are re-fetched through the dense kernel.
    """
    from .banded import _unpack2bit

    assert W <= 128
    N = meta.shape[1]
    TP, RP = _WS // 4, _SEG // 4
    tpl = _unpack2bit(chars_pack[:, :TP]).T
    reads = _unpack2bit(chars_pack[:, TP : TP + RP])
    steps = _unpack2bit(chars_pack[:, TP + RP :]).T.astype(jnp.int32)
    t_lens, seg_lens, c0, loc0 = meta[0], meta[1], meta[2], meta[3]
    centers = jnp.concatenate(
        [c0[None, :], c0[None, :] + jnp.cumsum(steps, axis=0)], axis=0)
    return _window_sparse_pack(tpl, reads, t_lens, seg_lens, centers, loc0, W)


@functools.partial(jax.jit, static_argnames=("W",))
def _nw_window_round_resident(arena, meta, W: int):
    """Windowed realign against the DEVICE ARENA: per-round templates
    and the per-batch cropped-read store live in device memory; the host
    copies 5 int32s of window coordinates per lane instead of the 192 B
    of 2-bit window chars.  Band centers are the proportional schedule,
    computed on device with the dispatch's exact integer formula.
    ``meta`` (5, N) int32 = [t_lens; seg_lens; loc0; tpl_start;
    seg_start] (starts absolute into the arena).  Output row =
    :func:`_nw_window_round_sparse`'s.
    """
    assert W <= 128
    return _window_sparse_pack(*_window_resident_inputs(arena, meta), W)


def _window_sparse_pack(tpl, reads, t_lens, seg_lens, centers, loc0, W):
    """Shared core: run the window DP and emit the sparse interior row."""
    N = reads.shape[0]
    sym, ins, jpath, _, _, _, _ = _nw_round_parts(
        tpl, t_lens, reads, seg_lens, centers,
        T=_WS, W=W, S=_WS + _SEG, NWIN=max(TB_nwin(_WS), 1),
        lead_free=2 * _LEAD_SLACK)
    idx_c = loc0[:, None] + jnp.arange(_ADV, dtype=jnp.int32)[None, :]
    idx_b = loc0[:, None] + jnp.arange(_ADV + 1, dtype=jnp.int32)[None, :]
    sym_i = jnp.take_along_axis(sym, idx_c, axis=1)  # (N, 126) int8
    tpl_i = jnp.take_along_axis(tpl.T.astype(jnp.int8), idx_c, axis=1)
    ins_i = jnp.take_along_axis(ins, idx_b[:, :, None], axis=1).astype(
        jnp.uint16)
    jp_i = jnp.take_along_axis(jpath, idx_b, axis=1).astype(jnp.int32)

    # covered interior columns / valid boundaries are contiguous runs
    ci = sym_i != 5
    colr = jnp.arange(_ADV, dtype=jnp.int32)[None, :]
    s0c = jnp.argmax(ci, axis=1).astype(jnp.int32)
    s1c = _ADV - jnp.argmax(ci[:, ::-1], axis=1).astype(jnp.int32)
    any_c = ci.any(axis=1)
    s0c = jnp.where(any_c, s0c, 0)
    s1c = jnp.where(any_c, s1c, 0)
    bv = jp_i >= 0
    bndr = jnp.arange(_ADV + 1, dtype=jnp.int32)[None, :]
    s0b = jnp.argmax(bv, axis=1).astype(jnp.int32)
    s1b = _ADV + 1 - jnp.argmax(bv[:, ::-1], axis=1).astype(jnp.int32) - 1
    any_b = bv.any(axis=1)
    s0b = jnp.where(any_b, s0b, 0)
    s1b = jnp.where(any_b, s1b, 0)
    base = jnp.take_along_axis(jp_i, s0b[:, None], axis=1)[:, 0]
    base = jnp.clip(jnp.where(any_b, base, 0), 0, 65535)

    # sym events
    ev = ci & (sym_i != tpl_i)
    code = (sym_i - (sym_i > tpl_i)).astype(jnp.int32)
    codes, sym_cnt = _scatter_events(ev, code, _WCAP_S, jnp.uint8)
    ev_pad = jnp.concatenate([ev, jnp.zeros((N, 2), bool)], axis=1)
    sym_mask = _packbits_dev(ev_pad)  # 16 B
    c4 = codes.reshape(N, _WCAP_S // 4, 4).astype(jnp.int32)
    sym_codes = (c4[:, :, 0] | (c4[:, :, 1] << 2) | (c4[:, :, 2] << 4)
                 | (c4[:, :, 3] << 6)).astype(jnp.uint8)  # 8 B

    # insertion events
    ins16 = (ins_i[:, :, 0] | (ins_i[:, :, 1] << 3)
             | (ins_i[:, :, 2] << 6) | (ins_i[:, :, 3] << 9))  # (N, 127)
    iev = ins16 != 0
    ivals, ins_cnt = _scatter_events(iev, ins16.astype(jnp.int32), _WCAP_I,
                                     jnp.uint16)
    iev_pad = jnp.concatenate([iev, jnp.zeros((N, 1), bool)], axis=1)
    ins_mask = _packbits_dev(iev_pad)  # 16 B

    # jpath deltas over valid boundaries
    d = jp_i[:, 1:] - jp_i[:, :-1]  # (N, 126)
    jd_in = (colr >= s0b[:, None]) & (colr < s1b[:, None]) & any_b[:, None]
    d = jnp.where(jd_in, d, 0)
    esc = d > 14
    nib = jnp.where(esc, 15, d).astype(jnp.int32)
    jp_nib = (nib[:, 0::2] | (nib[:, 1::2] << 4)).astype(jnp.uint8)  # 63 B
    jp_nib = jnp.concatenate([jp_nib, jnp.zeros((N, 1), jnp.uint8)], axis=1)
    evals, esc_cnt = _scatter_events(esc, jnp.clip(d, 0, 65535), _WCAP_E,
                                     jnp.uint16)

    ovf = ((sym_cnt > _WCAP_S) | (ins_cnt > _WCAP_I) | (esc_cnt > _WCAP_E))
    u8 = lambda x: x.astype(jnp.uint8)
    buf = jnp.concatenate([
        jp_nib,                                                    # 64
        jax.lax.bitcast_convert_type(evals, jnp.uint8).reshape(N, -1),  # 8
        u8(s0b[:, None]), u8(s1b[:, None]),
        u8(base[:, None] & 0xFF), u8(base[:, None] >> 8),          # 4
        sym_mask, sym_codes,                                       # 24
        u8(s0c[:, None]), u8(s1c[:, None]),                        # 2
        ins_mask,                                                  # 16
        jax.lax.bitcast_convert_type(ivals, jnp.uint8).reshape(N, -1),  # 48
        u8(ovf[:, None]), u8(any_b[:, None]),                      # 2
    ], axis=1)  # 168 B
    return jax.lax.bitcast_convert_type(
        buf.reshape(N, _WROW_SPARSE, 4), jnp.int32)


def _unpack_window_rows_sparse(packed: np.ndarray, tpl_i: np.ndarray):
    """Host inverse of :func:`_nw_window_round_sparse`.

    ``tpl_i`` (m, 126): each lane's interior template columns.  Returns
    (sym, ins, jpath, overflow_mask)."""
    m = packed.shape[0]
    buf = np.ascontiguousarray(packed).view(np.uint8).reshape(
        m, 4 * _WROW_SPARSE)
    jp_nib = buf[:, :64]
    esc_vals = buf[:, 64:72].copy().view(np.uint16)
    s0b = buf[:, 72].astype(np.int64)
    s1b = buf[:, 73].astype(np.int64)
    base = buf[:, 74].astype(np.int64) | (buf[:, 75].astype(np.int64) << 8)
    sym_mask = buf[:, 76:92]
    sym_codes = buf[:, 92:100]
    s0c = buf[:, 100].astype(np.int64)
    s1c = buf[:, 101].astype(np.int64)
    ins_mask = buf[:, 102:118]
    ins_vals = buf[:, 118:166].copy().view(np.uint16)
    ovf = buf[:, 166].astype(bool)
    any_b = buf[:, 167].astype(bool)

    colr = np.arange(_ADV, dtype=np.int64)[None, :]
    in_c = (colr >= s0c[:, None]) & (colr < s1c[:, None])
    sym = np.where(in_c, tpl_i, np.int8(5)).astype(np.int8)
    ev = np.unpackbits(sym_mask, axis=1, bitorder="little")[:, :_ADV].astype(bool)
    idx = np.cumsum(ev, axis=1) - 1
    codes = ((sym_codes[:, :, None] >> np.array([0, 2, 4, 6])) & 3).reshape(m, -1)
    rr, cc = np.nonzero(ev & (idx < _WCAP_S))
    cv = codes[rr, idx[rr, cc]].astype(np.int8)
    tv = tpl_i[rr, cc]
    sym[rr, cc] = cv + (cv >= tv)

    ins16 = np.zeros((m, _ADV + 1), np.uint16)
    bev = np.unpackbits(ins_mask, axis=1, bitorder="little")[:, : _ADV + 1].astype(bool)
    bidx = np.cumsum(bev, axis=1) - 1
    rr2, cc2 = np.nonzero(bev & (bidx < _WCAP_I))
    ins16[rr2, cc2] = ins_vals[rr2, bidx[rr2, cc2]]
    ins = np.empty((m, _ADV + 1, 4), np.int8)
    for s in range(4):
        ins[:, :, s] = ((ins16 >> (3 * s)) & 7).astype(np.int8)

    d = np.empty((m, _ADV + 1), np.int64)
    dn = np.empty((m, 2 * 63), np.int64)
    dn[:, 0::2] = jp_nib[:, :63] & 0xF
    dn[:, 1::2] = jp_nib[:, :63] >> 4
    d[:, :_ADV] = dn[:, :_ADV]
    d[:, _ADV] = 0
    jd_in = (np.arange(_ADV + 1)[None, :] < s1b[:, None]) & (
        np.arange(_ADV + 1)[None, :] >= s0b[:, None])
    esc = (d == 15) & jd_in
    eidx = np.cumsum(esc, axis=1) - 1
    rr3, cc3 = np.nonzero(esc & (eidx < _WCAP_E))
    d[rr3, cc3] = esc_vals[rr3, eidx[rr3, cc3]]
    d = np.where(jd_in, d, 0)
    csp = np.concatenate([np.zeros((m, 1), np.int64),
                          np.cumsum(d[:, :_ADV], axis=1)], axis=1)
    base_adj = (base - csp[np.arange(m), np.clip(s0b, 0, _ADV)])[:, None]
    bnd = np.arange(_ADV + 1, dtype=np.int64)[None, :]
    bnd_ok = (bnd >= s0b[:, None]) & (bnd <= s1b[:, None])
    jpath = np.where(bnd_ok & any_b[:, None], base_adj + csp, -1)
    return sym, ins, jpath, ovf


def _sharded_nw_window_round(mesh, W: int, sparse: bool = False):
    """:func:`_nw_window_round` under ``shard_map``: window lanes shard
    on ``dp``, packed rows are allgathered (identical results)."""
    key = (tuple(d.id for d in mesh.devices.flat), "win", W, sparse)
    fn = _SHARDED_ROUND_CACHE.get(key)
    if fn is not None:
        return fn
    from jax.sharding import PartitionSpec as P

    kern = _nw_window_round_sparse if sparse else _nw_window_round

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("dp", None), P(None, "dp")),
        out_specs=P(),
        check_vma=False,
    )
    def step(chars_pack, meta):
        out = kern(chars_pack, meta, W=W)
        return jax.lax.all_gather(out, "dp", axis=0, tiled=True)

    _SHARDED_ROUND_CACHE[key] = step
    return step


def _unpack_window_rows(packed: np.ndarray, cen_b: np.ndarray):
    """Host inverse of :func:`_nw_window_round`'s packing: returns
    (sym (m, 126) int8, ins (m, 127, 4) int8, jpath (m, 127) int64).

    ``cen_b`` (m, 127): band centers at the interior boundaries (the
    host rebuilds them from tlen/slen/loc0 — the same proportional
    formula the dispatch used), restoring absolute jpath from the
    biased byte offsets."""
    m = packed.shape[0]
    buf = np.ascontiguousarray(packed).view(np.uint8).reshape(m, 4 * _WROW)
    sym_p = buf[:, :63]
    sym = np.empty((m, _ADV), np.int8)
    sym[:, 0::2] = (sym_p >> 4).astype(np.int8)
    sym[:, 1::2] = (sym_p & 0xF).astype(np.int8)
    ins_p = buf[:, 64 : 64 + 2 * (_ADV + 1)].view(np.uint16)
    ins = np.empty((m, _ADV + 1, 4), np.int8)
    for s in range(4):
        ins[:, :, s] = ((ins_p >> (3 * s)) & 7).astype(np.int8)
    jb = buf[:, 64 + 2 * (_ADV + 1) : 64 + 3 * (_ADV + 1)].astype(np.int64)
    jp = np.where(jb == 255, -1, jb - 64 + cen_b)
    return sym, ins, jp


def _run_round_windowed(jobs, W: int, mesh=None):
    """Realign via independent path-anchored template windows.

    Every (read, window) pair becomes one lane of a SINGLE fixed shape
    (``_WS`` template rows × ``_SEG`` read chars): the full-template scan
    is latency-bound — one sequential DP row per template column — while
    window lanes of every read of every pile-up run in parallel, which is
    daccord's windowed-consensus structure mapped onto batched lanes
    (``dazzler.d:4196-4340``; w=40/advance 10 there, 192/126 here).  Only
    each window's interior ``_ADV`` columns contribute to the stitched
    result; the ``_MARGIN`` overlap is discarded, so window-boundary
    artifacts cannot vote.

    Jobs with ``dirty`` realign ONLY windows whose [b0, b1) span touches
    a dirty column; everything else carries ``prev``'s values forward
    (clean columns' template content is unchanged, so the carried
    alignments remain exact) — the incremental mode that makes polish
    iteration cost O(applied edits), not O(template).

    Returns ``(outs, failures)``: per-job :class:`_RoundOut` plus the
    (job, read) lanes that need the full banded scan (no usable previous
    path; full-realign jobs only).  Stitched ``win``/``diffs`` count
    insertion runs at their ≤4-rank cap — runs of 5+ at one boundary
    (vanishingly rare at 13 % error) undercount the QV signal slightly;
    votes are unaffected.
    """
    jobs = _as_jobs(jobs)
    lane_tpl, lane_seg = [], []
    lane_tlen, lane_seglen, lane_loc0 = [], [], []
    lane_tstart, lane_sstart = [], []
    per_job = []  # (rr, kk, i0, kend, b0, b1, jlo_s, lane_offset)
    failures: list[tuple[int, int]] = []
    total = 0
    # resident mode: the cropped reads live on device (batch upload) and
    # the templates upload once per call — lanes then ship coordinates
    res_mode = (bool(jobs) and (mesh is None or mesh.size <= 1)
                and all(j.seg_res is not None and j.read_offs is not None
                        for j in jobs))
    tpl_bases = None
    if res_mode:
        # preflight: the read store and the per-round templates must be
        # able to coexist in the arena, or the upload-retry loop in the
        # dispatcher could thrash (each template upload resetting the
        # arena and evicting the read store)
        from .banded import (RESIDENT_PAD, _ARENA_CHUNK, _RESIDENT_LADDER,
                             _arena_capacity)

        def _bucket(n):
            b = next(x for x in _RESIDENT_LADDER if max(n, 4) <= x)
            return max(b, -(-n // _ARENA_CHUNK) * _ARENA_CHUNK)

        seg_len = len(jobs[0].seg_res.codes)
        tpl_len = sum(len(j.template) for j in jobs)
        if (_bucket(seg_len) + _bucket(tpl_len) + 3 * RESIDENT_PAD
                > _arena_capacity()):
            res_mode = False
    if res_mode:
        tpl_bases = np.concatenate(
            [[0], np.cumsum([len(j.template) for j in jobs])])[:-1]
    _t_build = time.perf_counter()
    for wi, job in enumerate(jobs):
        template, reads, jp = job.template, job.reads, job.jpath
        T = len(template)
        n = len(reads)
        nwin = -(-T // _ADV)
        valid = jp >= 0
        nvalid = valid.sum(axis=1)
        s = np.argmax(valid, axis=1)
        e = T - np.argmax(valid[:, ::-1], axis=1)  # last valid boundary
        ok_read = nvalid >= 2
        if job.dirty is None:
            for ri in np.flatnonzero(~ok_read):
                failures.append((wi, int(ri)))
        k = np.arange(nwin)
        i0 = k * _ADV
        kend = np.minimum(i0 + _ADV, T)
        b0 = np.maximum(i0 - _MARGIN, 0)
        b1 = np.minimum(i0 + _ADV + _MARGIN, T)
        rel = (ok_read[:, None] & (i0[None, :] < e[:, None])
               & (kend[None, :] > s[:, None]))
        if job.dirty is not None:
            cumd = np.concatenate([[0], np.cumsum(job.dirty)])
            rel &= (cumd[b1] - cumd[b0] > 0)[None, :]
        lo_b = np.maximum(b0[None, :], s[:, None])
        hi_b = np.minimum(b1[None, :], e[:, None])
        jlo = np.take_along_axis(jp, np.clip(lo_b, 0, T), axis=1)
        jhi = np.take_along_axis(jp, np.clip(hi_b, 0, T), axis=1)
        rel &= (jlo >= 0) & (jhi > jlo)
        rr, kk = np.nonzero(rel)
        L = len(rr)
        if L == 0:
            per_job.append(None)
            continue
        jl = np.maximum(jlo[rr, kk] - _LEAD_SLACK, 0)
        jl = np.maximum(jl, jhi[rr, kk] - _SEG)
        seg_len = jhi[rr, kk] - jl
        t_len = (b1 - b0)[kk]
        tidx = b0[kk][:, None] + np.arange(_WS)[None, :]
        tmask = tidx < b1[kk][:, None]
        lane_tpl.append(np.where(
            tmask, template[np.minimum(tidx, max(T - 1, 0))], 0).astype(np.uint8))
        if res_mode:
            lane_tstart.append(tpl_bases[wi] + b0[kk])
            lane_sstart.append(job.read_offs[rr] + jl)
        else:
            reads_arr = job.reads_u8()
            RL = reads_arr.shape[1]
            sidx = jl[:, None] + np.arange(_SEG)[None, :]
            smask = np.arange(_SEG)[None, :] < seg_len[:, None]
            lane_seg.append(np.where(
                smask, reads_arr[rr[:, None], np.minimum(sidx, RL - 1)], 0))
        lane_tlen.append(t_len)
        lane_seglen.append(seg_len)
        lane_loc0.append((i0 - b0)[kk])
        per_job.append((rr, kk, i0, kend, b0, b1, jl, total))
        total += L

    prof_add("cons.win.build", time.perf_counter() - _t_build,
             hits=len(jobs))
    resident = None
    if res_mode:
        resident = (jobs[0].seg_res,
                    np.concatenate([j.template for j in jobs])
                    if jobs else np.zeros(0, np.uint8),
                    lane_tstart, lane_sstart)
    with prof("cons.win.dispatch+fetch"):  # bytes: see cons.win.fetch
        fetched = _dispatch_windowed_lanes(
            lane_tpl, lane_tlen, lane_seg, lane_seglen, lane_loc0, total, W,
            mesh, resident=resident)
    prof_add("cons.win.lanes", hits=total)

    _t_stitch = time.perf_counter()

    def stitch_one(wi):
        job = jobs[wi]
        template, reads = job.template, job.reads
        T = len(template)
        n = len(reads)
        NWIN = max(TB_nwin(T), 1)
        incremental = job.dirty is not None and job.prev is not None
        if incremental:
            sym_g = job.prev.sym.copy()
            ins_g = job.prev.ins.copy()
            jp_g = job.prev.jpath.copy()
            fresh_cols = np.zeros(T, dtype=bool)
            fresh_bnds = np.zeros(T + 1, dtype=bool)
        else:
            sym_g = np.full((n, T), 5, np.int8)
            ins_g = np.zeros((n, T + 1, 4), np.int8)
            jp_g = np.full((n, T + 1), -1, np.int64)
            fresh_cols = fresh_bnds = None
        meta = per_job[wi]
        if meta is not None:
            rr, kk, i0, kend, b0, b1, jl, off = meta
            L = len(rr)
            sym_l, ins_l, jpath_l = (fetched[0][off : off + L],
                                     fetched[1][off : off + L],
                                     fetched[2][off : off + L])
            # lane arrays are interior-only (device-side extraction):
            # column c of sym_l is global column i0 + c
            cols = i0[kk][:, None] + np.arange(_ADV)[None, :]
            cmask = cols < kend[kk][:, None]
            ccols = np.minimum(cols, T - 1)  # safe pre-mask (cmask ⇒ < T)
            flat_cols = (rr[:, None] * T + ccols)[cmask]
            flat_bnds = (rr[:, None] * (T + 1) + ccols)[cmask]
            sym_g.reshape(-1)[flat_cols] = sym_l[cmask]
            jvals = np.where(jpath_l >= 0, jpath_l + jl[:, None], -1)
            jp_g.reshape(-1)[flat_bnds] = jvals[:, :_ADV][cmask]
            ins_g.reshape(n * (T + 1), 4)[flat_bnds] = ins_l[:, :_ADV][cmask]
            # final boundary T comes from the last window's interior end
            last = kend[kk] == T
            if last.any():
                wid = (kend - i0)[kk][last]
                lanes_last = np.flatnonzero(last)
                jp_g[rr[last], T] = jvals[lanes_last, wid]
                ins_g[rr[last], T] = ins_l[lanes_last, wid]
            if incremental:
                wk = np.unique(kk)
                for k_ in wk:
                    fresh_cols[i0[k_] : kend[k_]] = True
                    fresh_bnds[i0[k_] : kend[k_] + (kend[k_] == T)] = True
        # derived per-read statistics from the stitched columns
        tplv = template[None, :T]
        mism = (sym_g < 4) & (sym_g != tplv)
        dele = sym_g == 4
        contrib_col = mism.astype(np.int64) + dele
        ins_cnt = (ins_g != 0).sum(axis=2).astype(np.int64)
        bounds = np.arange(0, max(T, 1), TRACE_SPACING)[:NWIN]
        win_cols = np.add.reduceat(contrib_col, bounds, axis=1) if T else \
            np.zeros((n, NWIN), np.int64)
        win_ins = np.add.reduceat(ins_cnt[:, : T + 1], bounds, axis=1)
        win = (win_cols + win_ins).astype(np.int32)
        diffs = contrib_col.sum(axis=1) + ins_cnt.sum(axis=1)
        covered_cols = sym_g != 5
        covered = covered_cols.any(axis=1)
        first = np.argmax(covered_cols, axis=1)
        last_c = T - np.argmax(covered_cols[:, ::-1], axis=1)
        spans = np.stack([np.where(covered, first, 0),
                          np.where(covered, last_c, 0)], axis=1)
        fails = []
        # defensively retry reads whose windows all failed to stitch
        if meta is not None and job.dirty is None:
            for ri in np.flatnonzero(~covered):
                if (wi, int(ri)) not in failures and len(reads[ri]):
                    fails.append((wi, int(ri)))
        return _RoundOut(sym_g, ins_g, jp_g, spans,
                         np.where(covered, diffs, 0), win, covered,
                         fresh_cols, fresh_bnds), fails

    # per-job stitching is independent numpy; thread it (serial, it was
    # ~10 s at 147-pile-up scale on a 4-core host)
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=4) as ex:
        stitched = list(ex.map(stitch_one, range(len(jobs))))
    outs = [s[0] for s in stitched]
    for _, fails in stitched:
        failures.extend(fails)
    prof_add("cons.win.stitch", time.perf_counter() - _t_stitch,
             hits=len(jobs))
    return outs, failures


#: windowed chunk width: several in-flight chunks overlap their result
#: fetches (one huge chunk fetches serially)
_WCHUNK = 2048


def _dispatch_windowed_lanes(lane_tpl, lane_tlen, lane_seg, lane_seglen,
                             lane_loc0, total: int, W: int, mesh=None,
                             resident=None):
    """Dispatch all window lanes in fixed-shape chunks with overlapped
    fetches; returns stacked interior-only (sym, ins, jpath) host arrays
    (see :func:`_nw_window_round` for the packed row layout)."""
    sym_all = np.full((total, _ADV), 5, np.int8)
    ins_all = np.zeros((total, _ADV + 1, 4), np.int8)
    jp_all = np.full((total, _ADV + 1), -1, np.int64)
    if total == 0:
        return sym_all, ins_all, jp_all
    tpl = np.concatenate(lane_tpl)
    tlen = np.concatenate(lane_tlen).astype(np.int32)
    slen = np.concatenate(lane_seglen).astype(np.int32)
    loc0 = np.concatenate(lane_loc0).astype(np.int32)
    rows = np.arange(_WS + 1, dtype=np.int32)
    use_sparse = not os.environ.get("DENTIST_TPU_DENSE_CONS")
    seg = arena = tstart = sstart = None
    if resident is not None:
        from .banded import ARENA

        seg_ref, tpl_flat, lane_tstart, lane_sstart = resident
        with ARENA.lock:  # both offsets + array from one arena state
            for _attempt in range(4):
                seg_base = seg_ref.offset()
                tpl_base = ARENA.offset_of(tpl_flat, cache=False)
                # the template upload may have reset a full arena,
                # wiping the read store — redo both until stable (the
                # caller's preflight guarantees they coexist, so this
                # settles in <= 2 iterations)
                if ARENA.epoch == seg_ref.epoch:
                    break
            else:
                raise MemoryError(
                    "consensus stores do not fit the device arena")
            arena = ARENA.array
        tstart = np.concatenate(lane_tstart).astype(np.int32) + tpl_base
        sstart = np.concatenate(lane_sstart).astype(np.int32) + seg_base
    else:
        seg = np.concatenate(lane_seg)

    from .banded import _pack2bit

    def dispatch(sel, dense=False):
        m = len(sel)
        # accelerators: ONE windowed shape (the rationale was per-process
        # program loads over the former remote backend; unmeasured on the
        # GPU); CPU tests keep the ladder
        Nc = (_WCHUNK if _is_accel()
              else next((b for b in _N_LADDER if m <= b <= _WCHUNK), _WCHUNK))
        if mesh is not None and mesh.size > 1 and Nc % mesh.size:
            Nc = -(-Nc // mesh.size) * mesh.size  # non-power-of-2 meshes
        if resident is not None:
            meta = np.zeros((5, Nc), np.int32)
            meta[0] = 1
            meta[0, :m] = tlen[sel]
            meta[1, :m] = slen[sel]
            meta[2, :m] = loc0[sel]
            meta[3, :m] = tstart[sel]
            meta[4, :m] = sstart[sel]
            kern = (_nw_window_round_resident_dense if dense
                    else _nw_window_round_resident)
            return kern(arena, jnp.asarray(meta), W=W)
        tpl_c = np.zeros((Nc, _WS), np.uint8)
        seg_c = np.zeros((Nc, _SEG), np.uint8)
        meta = np.zeros((4, Nc), np.int32)
        meta[0] = 1
        tpl_c[:m] = tpl[sel]
        seg_c[:m] = seg[sel]
        meta[0, :m] = tlen[sel]
        meta[1, :m] = slen[sel]
        meta[3, :m] = loc0[sel]
        # proportional band-center steps, computed directly per chunk:
        # c(r) = min(r, tlen)·slen // tlen has steps in {0, 1, 2} whenever
        # slen ≤ 2·tlen (floor-sequence property); the rare over-slope
        # lane saturates at 2 via the clip, fails coverage, and is
        # retried — same outcome as the former running-min clamp
        tl = np.maximum(tlen[sel, None], 1)
        cen = (np.minimum(rows[None, :], tl) * slen[sel, None]) // tl
        steps = np.zeros((Nc, _WS), np.uint8)
        steps[:m] = np.diff(cen, axis=1).clip(0, 2)
        chars_pack = np.concatenate(
            [_pack2bit(tpl_c), _pack2bit(seg_c), _pack2bit(steps)], axis=1)
        sparse = use_sparse and not dense
        if mesh is not None and mesh.size > 1:
            from jax.sharding import PartitionSpec as P

            from ..parallel.dp import stage_global

            return _sharded_nw_window_round(mesh, W, sparse=sparse)(
                stage_global(mesh, P("dp", None), chars_pack),
                stage_global(mesh, P(None, "dp"), meta))
        kern = _nw_window_round_sparse if sparse else _nw_window_round
        return kern(jnp.asarray(chars_pack), jnp.asarray(meta), W=W)

    from concurrent.futures import ThreadPoolExecutor

    from ..parallel.dp import dispatch_workers

    plan = [np.arange(c0, min(c0 + _WCHUNK, total))
            for c0 in range(0, total, _WCHUNK)]
    with prof("cons.win.enqueue"):
        with ThreadPoolExecutor(max_workers=dispatch_workers(4)) as ex:
            # launches serialize on multi-process meshes (collective order)
            handles = list(ex.map(dispatch, plan))
    with prof("cons.win.fetch"):
        with ThreadPoolExecutor(max_workers=4) as ex:
            arrs = list(ex.map(np.asarray, handles))
    prof_add("cons.win.fetch", nbytes=sum(a.nbytes for a in arrs), hits=0)
    bnd = np.arange(_ADV + 1, dtype=np.int64)[None, :]
    intr = np.arange(_ADV, dtype=np.int64)[None, :]

    def decode_dense(sel, packed):
        # band centers at the interior boundaries (rows loc0..loc0+126)
        r = loc0[sel, None] + bnd
        tl = np.maximum(tlen[sel, None].astype(np.int64), 1)
        cen_b = np.minimum(r, tl) * slen[sel, None] // tl
        return _unpack_window_rows(packed[: len(sel)], cen_b)

    ovf_idx: list[int] = []

    def decode_one(args):
        sel, packed = args
        m = len(sel)
        if use_sparse:
            tpl_i = tpl[sel[:, None], loc0[sel, None] + intr].astype(np.int8)
            sym, ins, jp, ovf = _unpack_window_rows_sparse(packed[:m], tpl_i)
            if ovf.any():
                ovf_idx.extend(sel[np.flatnonzero(ovf)].tolist())
        else:
            sym, ins, jp = decode_dense(sel, packed)
        sym_all[sel] = sym
        ins_all[sel] = ins
        jp_all[sel] = jp

    # decode on a pool: numpy's unpack/cumsum passes release the GIL,
    # and the serial loop was ~half the windowed rounds' wall at scale
    with ThreadPoolExecutor(max_workers=4) as ex:
        list(ex.map(decode_one, zip(plan, arrs)))
    if ovf_idx:
        # cap-overflow lanes (error-dense windows): exact dense refetch
        # of just those lanes through the dense kernel
        prof_add("cons.win.ovf_refetch", hits=len(ovf_idx))
        # sorted: the decode pool accumulates in completion order, but
        # refetch chunk composition must be deterministic (multi-process
        # meshes enqueue these dispatches as collectives)
        allsel = np.asarray(sorted(ovf_idx), dtype=np.int64)
        for c0 in range(0, len(allsel), _WCHUNK):
            sub = allsel[c0 : c0 + _WCHUNK]
            packed = np.asarray(dispatch(sub, dense=True))
            sym, ins, jp = decode_dense(sub, packed)
            sym_all[sub] = sym
            ins_all[sub] = ins
            jp_all[sub] = jp
    return sym_all, ins_all, jp_all


def _dispatch_chunk(lanes, chunk, TB, W, centers_for, mesh=None,
                    dense=False):
    """Assemble + dispatch one chunk; returns ``(handle, centers)`` —
    the async device handle plus the chunk's band centers (the host
    needs them to restore absolute jpath from the packed in-band
    offsets, see :func:`_collect_chunk`).  ``dense`` selects the dense
    result block (sparse-cap overflow refetches).

    ``centers_for(lane_idx)`` supplies each lane's precomputed
    step-clamped band-center column.  The lane count is padded to one of
    exactly TWO shapes per T bucket (``_N_SMALL`` or the move-budget
    width) so retries and remainders reuse the main compiled programs.
    """
    from .banded import _pack2bit

    RLB = _rl_bucket(0, TB)
    N = _n_bucket_lanes(len(chunk), TB, W)
    if mesh is not None and mesh.size > 1 and N % mesh.size:
        # non-power-of-2 meshes (e.g. 6 hosts): pad to a lane multiple
        N = -(-N // mesh.size) * mesh.size
    tpl = np.zeros((N, TB), dtype=np.uint8)
    t_lens = np.ones(N, dtype=np.int32)
    reads_arr = np.zeros((N, RLB), dtype=np.uint8)
    read_lens = np.zeros(N, dtype=np.int32)
    centers = np.zeros((TB + 1, N), dtype=np.int32)
    for k, li in enumerate(chunk):
        ji, ri, template, r = lanes[li]
        T = len(template)
        tpl[k, :T] = template
        t_lens[k] = T
        rl = min(len(r), RLB)  # see _rl_bucket: >2·T reads cannot pass anyway
        reads_arr[k, :rl] = r[:rl]
        read_lens[k] = rl
        c = centers_for(li)
        centers[: T + 1, k] = c
        centers[T + 1 :, k] = c[T]
    NWIN = max(TB_nwin(TB), 1)
    steps = np.clip(np.diff(centers, axis=0), 0, 2).astype(np.uint8).T  # (N, TB)
    chars_pack = np.concatenate(
        [_pack2bit(tpl), _pack2bit(reads_arr), _pack2bit(steps)], axis=1)
    meta = np.concatenate([t_lens, read_lens, centers[0].astype(np.int32)])
    if mesh is not None and mesh.size > 1:
        from jax.sharding import PartitionSpec as P

        from ..parallel.dp import stage_global

        return _sharded_nw_round(mesh, TB, RLB, W, TB + RLB, NWIN,
                                 sparse=not dense)(
            stage_global(mesh, P("dp", None), chars_pack),
            stage_global(mesh, P(None, "dp"), meta.reshape(3, N))), centers
    kern = _nw_round_packed if dense else _nw_round_packed_sparse
    return kern(jnp.asarray(chars_pack), jnp.asarray(meta),
                T=TB, RL=RLB, W=W, S=TB + RLB, NWIN=NWIN), centers


#: compiled sharded consensus kernels keyed by (mesh devices, shape)
_SHARDED_ROUND_CACHE: dict = {}


def _sharded_nw_round(mesh, T: int, RL: int, W: int, S: int, NWIN: int,
                      lead_free: int = -1, sparse: bool = False):
    """The consensus realign kernel under ``shard_map`` over ``mesh``.

    The mesh-parallel process stage (SURVEY §2.4 "pile-up batches across
    chips; allgather insertions"; the reference's ``--batch`` slices +
    ``merge-insertions``, ``snakemake/Snakefile:1315-1358``): lanes —
    independent (template, read) pairs drawn from many pile-ups — shard
    on ``dp``; the packed per-lane result block is **allgathered** so
    every device (host) holds every lane's result.  Per-lane math is the
    single-device kernel, so sharded output == single-device output
    exactly (asserted by ``tests/test_consensus.py``).
    """
    key = (tuple(d.id for d in mesh.devices.flat), T, RL, W, S, NWIN,
           lead_free, sparse)
    fn = _SHARDED_ROUND_CACHE.get(key)
    if fn is not None:
        return fn
    from jax.sharding import PartitionSpec as P

    kern = _nw_round_packed_sparse if sparse else _nw_round_packed

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("dp", None), P(None, "dp")),
        out_specs=P(),
        check_vma=False,  # the trailing all_gather replicates the output
    )
    def step(chars_pack, meta3):
        out = kern(chars_pack, meta3.reshape(-1),
                   T=T, RL=RL, W=W, S=S, NWIN=NWIN, lead_free=lead_free)
        return jax.lax.all_gather(out, "dp", axis=0, tiled=True)

    _SHARDED_ROUND_CACHE[key] = step
    return fn or step


def _collect_chunk_sparse(lanes, chunk, TB, outs, only_if_better=False,
                          fetched=None):
    """Decode a sparse result block (:func:`_nw_round_packed_sparse`)
    back into the EXACT dense per-lane arrays of the dense path.

    Returns the chunk-local indices of lanes whose event counts
    overflowed the sparse caps — the caller re-fetches those through
    the dense kernel."""
    T = TB
    NWIN = max(TB_nwin(T), 1)
    CAP_S, CAP_I = _sparse_caps(T)
    m = len(chunk)
    packed = np.ascontiguousarray(fetched)
    nbyte_sec = (T // 2 + 2 * _CAP_E + T // 8 + 3 * T // 64 + (T // 8 + 4)
                 + 2 * (3 * T // 16))
    u8 = packed[:m, : nbyte_sec // 4].copy().view(np.uint8).reshape(m, -1)
    misc = packed[:m, nbyte_sec // 4 : nbyte_sec // 4 + 6]
    win = packed[:m, nbyte_sec // 4 + 6 :]
    o = 0
    jp_nib = u8[:, o : o + T // 2]; o += T // 2
    esc_vals = u8[:, o : o + 2 * _CAP_E].copy().view(np.uint16); o += 2 * _CAP_E
    sym_mask = u8[:, o : o + T // 8]; o += T // 8
    sym_codes = u8[:, o : o + 3 * T // 64]; o += 3 * T // 64
    ins_mask = u8[:, o : o + T // 8 + 4]; o += T // 8 + 4
    ins_vals = u8[:, o : o + 2 * CAP_I].copy().view(np.uint16)

    jp_base = misc[:, 0].astype(np.int64)
    s0 = misc[:, 1].astype(np.int64)
    s1 = misc[:, 2].astype(np.int64)
    diffs = misc[:, 3]
    covered = misc[:, 4].astype(bool)
    ovf = misc[:, 5].astype(bool)

    # per-lane templates (the baseline sym for covered columns)
    tplmat = np.zeros((m, T), dtype=np.int8)
    for k, li in enumerate(chunk):
        template = lanes[li][2]
        tplmat[k, : len(template)] = template[:T]
    colr = np.arange(T, dtype=np.int64)[None, :]
    in_span = (colr >= s0[:, None]) & (colr < s1[:, None]) & covered[:, None]

    # ---- sym
    sym = np.where(in_span, tplmat, np.int8(5)).astype(np.int8)
    ev = np.unpackbits(sym_mask, axis=1, bitorder="little")[:, :T].astype(bool)
    idx = np.cumsum(ev, axis=1) - 1
    codes = ((sym_codes[:, :, None] >> np.array([0, 2, 4, 6])) & 3).reshape(
        m, -1)
    rr, cc = np.nonzero(ev & (idx < CAP_S))
    cv = codes[rr, idx[rr, cc]].astype(np.int8)
    tv = tplmat[rr, cc]
    sym[rr, cc] = cv + (cv >= tv)

    # ---- ins
    ins16 = np.zeros((m, T + 1), np.uint16)
    bev = np.unpackbits(ins_mask, axis=1, bitorder="little")[:, : T + 1].astype(bool)
    bidx = np.cumsum(bev, axis=1) - 1
    rr2, cc2 = np.nonzero(bev & (bidx < CAP_I))
    ins16[rr2, cc2] = ins_vals[rr2, bidx[rr2, cc2]]
    ins = np.empty((m, T + 1, 4), np.int8)
    for s in range(4):
        ins[:, :, s] = ((ins16 >> (3 * s)) & 7).astype(np.int8)

    # ---- jpath from deltas
    d = np.empty((m, T), np.int64)
    d[:, 0::2] = jp_nib & 0xF
    d[:, 1::2] = jp_nib >> 4
    esc = (d == 15) & in_span
    eidx = np.cumsum(esc, axis=1) - 1
    rr3, cc3 = np.nonzero(esc & (eidx < _CAP_E))
    d[rr3, cc3] = esc_vals[rr3, eidx[rr3, cc3]]
    d = np.where(in_span, d, 0)
    csp = np.concatenate([np.zeros((m, 1), np.int64),
                          np.cumsum(d, axis=1)], axis=1)  # (m, T+1)
    base_adj = (jp_base - csp[np.arange(m), np.clip(s0, 0, T)])[:, None]
    bnd = np.arange(T + 1, dtype=np.int64)[None, :]
    bnd_ok = (bnd >= s0[:, None]) & (bnd <= s1[:, None]) & covered[:, None]
    jpath = np.where(bnd_ok, base_adj + csp, -1)

    overflow = []
    for k, li in enumerate(chunk):
        if ovf[k]:
            overflow.append(k)
            continue
        ji, ri = lanes[li][0], lanes[li][1]
        if only_if_better and not covered[k]:
            continue
        outs[(ji, ri)] = (sym[k], ins[k], jpath[k],
                          np.array([s0[k], s1[k]]), diffs[k], win[k],
                          bool(covered[k]))
    return overflow


def _collect_chunk(lanes, chunk, TB, outs, only_if_better=False,
                   fetched=None, centers=None):
    """Unpack a fetched chunk's packed block per lane (the inverse of
    :func:`_nw_round_kernel`'s packing; ``centers`` (TB+1, N) restores
    absolute jpath from the in-band int16 offsets)."""
    packed = fetched
    # device results can come back with a non-row-major layout (XLA picks
    # the on-device layout), which breaks the uint8 reinterpretation
    # below — force C order (no-op when already so)
    packed = np.ascontiguousarray(packed)
    NWIN = max(TB_nwin(TB), 1)
    N_r = packed.shape[0]
    n_sym = TB // 8
    n_half = (TB + 2) // 2
    nib = np.ascontiguousarray(packed[:, :n_sym]).view(np.uint8)
    sym = np.empty((N_r, TB), np.int8)
    sym[:, 0::2] = (nib >> 4).astype(np.int8)
    sym[:, 1::2] = (nib & 0xF).astype(np.int8)
    ins16 = np.ascontiguousarray(
        packed[:, n_sym : n_sym + n_half]).view(np.uint16)[:, : TB + 1]
    ins = np.empty((N_r, TB + 1, 4), np.int8)
    for s in range(4):
        ins[:, :, s] = ((ins16 >> (3 * s)) & 7).astype(np.int8)
    jrel = np.ascontiguousarray(
        packed[:, n_sym + n_half : n_sym + 2 * n_half]).view(np.int16)
    jrel = jrel[:, : TB + 1].astype(np.int64)
    jpath = np.where(jrel == -32768, -1, jrel + centers.T[:N_r])
    rest = packed[:, n_sym + 2 * n_half :]
    spans = rest[:, :2]
    diffs = rest[:, 2]
    win = rest[:, 3 : 3 + NWIN]
    covered = rest[:, 3 + NWIN].astype(bool)
    for k, li in enumerate(chunk):
        ji, ri = lanes[li][0], lanes[li][1]
        if only_if_better and not covered[k]:
            continue
        outs[(ji, ri)] = (sym[k], ins[k], jpath[k], spans[k], diffs[k],
                          win[k], bool(covered[k]))


# ======================================================================
# Voting + template rebuild (vectorized host passes)
# ======================================================================


def _votes_of(out: _RoundOut, T: int):
    """(col_votes (T, 5), ins_votes (T+1, 4, 4), cov (T,))."""
    n = out.sym.shape[0]
    if T == 0 or n == 0:
        return (np.zeros((T, 5), np.int32), np.zeros((T + 1, 4, 4), np.int32),
                np.zeros(T, np.int32))
    with prof("cons.votes"):
        onehot = out.sym[:, :, None] == np.arange(5, dtype=np.int8)[None, None, :]
        col_votes = onehot.sum(axis=0).astype(np.int32)
        ins_votes = (out.ins[:, :, :, None]
                     == np.arange(1, 5, dtype=np.int8)[None, None, None, :]).sum(
            axis=0).astype(np.int32)
        cov = col_votes.sum(axis=1).astype(np.int32)
    return col_votes, ins_votes, cov


def _rebuild_template(template: np.ndarray, col_votes, ins_votes, cov):
    """Per-column majority + majority-supported insertions (vectorized).

    Returns ``(new_template, src_bnd)`` where ``src_bnd`` (len+1,) maps
    each new boundary to its source boundary in the old template — the
    exact column correspondence that lets the previous round's traceback
    paths (``jpath``) follow template edits (the windowed realign rounds
    anchor on them; a linear stretch would drift by the edit count).
    """
    T = len(template)
    covered = np.flatnonzero(cov > 0)
    lo, hi = (int(covered[0]), int(covered[-1]) + 1) if len(covered) else (0, T)
    # trim junk edge columns: leading/trailing template bases that only
    # coincidentally collect votes (free end gaps bypass them, so they
    # show a sharp coverage jump relative to the adjacent interior)
    while lo < hi - 1 and cov[lo] * 3 < cov[min(lo + 8, hi - 1)]:
        lo += 1
    while hi - 1 > lo and cov[hi - 1] * 3 < cov[max(hi - 9, lo)]:
        hi -= 1

    idx = np.arange(lo, hi)
    # insertion reference coverage: cov[i-1] for i > 0 else cov[i]
    cov_ref = np.maximum(np.where(idx > 0, cov[np.maximum(idx - 1, 0)], cov[idx]), 1)
    iv = ins_votes[lo:hi]  # (M, 4 ranks, 4 bases)
    ins_accept = iv.max(axis=2) * 2 > cov_ref[:, None]  # (M, 4)
    ins_base = iv.argmax(axis=2)  # (M, 4)

    v = col_votes[lo:hi]
    vsum = v.sum(axis=1)
    col_keep = (vsum == 0) | ~(v[:, 4] * 2 > vsum)
    col_char = np.where(vsum == 0, template[lo:hi], v[:, :4].argmax(axis=1))

    # row-major (column, slot) emission: 4 insertion slots then the column
    M = hi - lo
    vals = np.empty((M, 5), dtype=np.int64)
    keep = np.empty((M, 5), dtype=bool)
    vals[:, :4] = ins_base
    keep[:, :4] = ins_accept
    vals[:, 4] = col_char
    keep[:, 4] = col_keep
    parts = vals.reshape(-1)[keep.reshape(-1)]
    # each kept element's pre-boundary is its source column (insertion
    # slots precede column i; the column base sits between i and i+1)
    parts_src = np.repeat(idx, 5)[keep.reshape(-1)]

    # trailing insertions at boundary hi
    iv_hi = ins_votes[hi]
    c_hi = max(cov[hi - 1] if hi > 0 else 1, 1)
    tail_accept = iv_hi.max(axis=1) * 2 > c_hi
    tail = iv_hi.argmax(axis=1)[tail_accept]
    src_bnd = np.concatenate(
        [parts_src, np.full(len(tail) + 1, hi, dtype=np.int64)])
    return np.concatenate([parts, tail]).astype(np.uint8), src_bnd


def _rebuild_maps(old_template: np.ndarray, new_template: np.ndarray,
                  src_bnd: np.ndarray):
    """Column map + changed-column mask for a template rebuild.

    ``src_col[i]`` is the old column new column ``i`` copies (−1 when
    inserted); ``dirty[i]`` marks columns whose content or local
    structure changed (insertion, deletion in the neighborhood, revoted
    base, or edge trim) — the realign set for the next round.
    """
    T_new = len(new_template)
    d = np.diff(src_bnd)
    copied = d == 1
    src_col = np.where(copied, src_bnd[:-1], -1)
    dirty = ~copied  # insertions (d == 0) and deletion sites (d > 1)
    if T_new and len(old_template):
        sc = np.minimum(np.maximum(src_col, 0), len(old_template) - 1)
        dirty |= copied & (new_template != old_template[sc])
        if src_bnd[0] != 0:  # leading trim: col 0's left context changed
            dirty[0] = True
        if src_bnd[-1] != len(old_template):
            dirty[-1] = True
    return src_col, dirty


# ======================================================================
# Polish: exact-objective hill climb, batched across pile-ups
# ======================================================================


@functools.partial(jax.jit, static_argnames=("T", "global_ends"))
def _nw_dist_full(templates, t_lens, reads, read_lens, T: int,
                  global_ends: bool = False):
    """Edit distance of each (template, read) pair over the FULL read
    width — for the short polish-scoring windows (reads ≤ 127 chars) a
    full wavefront needs no band shifts and therefore no gathers at all,
    which beats the banded kernel by a wide margin.

    templates: (V, T); reads: (V, N, RL), RL ≤ 127.  Same free-shift /
    global semantics as :func:`_banded_nw_dist`; exact (no band to fall
    out of).  Returns (V, N) int32 distances.
    """
    templates = templates.astype(jnp.int32)
    reads = reads.astype(jnp.int32)
    V, N, RL = reads.shape
    j = jnp.arange(RL + 1, dtype=jnp.int32)[None, None, :]  # (1,1,RL+1)
    rl = read_lens[..., None]  # (V, N, 1)
    valid_j = j <= rl
    D0 = jnp.where(valid_j, j if global_ends else 0, _INF).astype(jnp.int32)
    best0 = jnp.full((V, N), _INF, dtype=jnp.int32)
    inf_col = jnp.full((V, N, 1), _INF, jnp.int32)

    def body(carry, xs):
        D_prev, best_end = carry
        t_ch, i = xs  # (V,), scalar row
        sub = (reads != t_ch[:, None, None]).astype(jnp.int32)  # (V,N,RL)
        diag = jnp.concatenate([inf_col, D_prev[..., :-1] + sub], axis=-1)
        up = D_prev + 1
        if not global_ends:
            # free leading template gap: entering at j == 0 costs nothing
            up = jnp.concatenate([jnp.minimum(up[..., :1], 0), up[..., 1:]],
                                 axis=-1)
        tmp = jnp.minimum(diag, up)
        active = i <= t_lens[:, None, None]
        tmp = jnp.where(valid_j & active, tmp, _INF)
        closed = jax.lax.associative_scan(jnp.minimum, tmp - j, axis=-1)
        D = jnp.minimum(tmp, closed + j)
        D = jnp.where(valid_j & active, jnp.minimum(D, _INF), _INF)
        if global_ends:
            at_end = jnp.where((j == rl) & (i == t_lens[:, None, None]),
                               D, _INF).min(axis=-1)
        else:
            at_end = jnp.where(j == rl, D, _INF).min(axis=-1)
        best_end = jnp.minimum(best_end, at_end)
        row_last = jnp.where(i == t_lens[:, None, None], D, _INF).min(axis=-1)
        return (D, best_end), row_last

    rows = jnp.arange(1, T + 1, dtype=jnp.int32)
    (D_last, best_end), row_last = jax.lax.scan(
        body, (D0, best0), (templates.T, rows))
    if global_ends:
        return best_end
    return jnp.minimum(best_end, row_last.min(axis=0))


@functools.partial(jax.jit, static_argnames=("T", "W", "global_ends"))
def _banded_nw_dist(templates, t_lens, reads, read_lens, T: int, W: int,
                    global_ends: bool = False):
    """Edit distance of each (template, read) pair, free-shift or global.

    templates: (V, T) int32; reads: (V, N, RL) int32 — variant v is scored
    against its own read set.  Returns (V, N) int32 distances.
    Forward-only: no move storage; scores candidate template edits
    exactly.  With ``global_ends`` both ends are anchored (true NW).
    """
    templates = templates.astype(jnp.int32)
    reads = reads.astype(jnp.int32)
    V, N, RL = reads.shape
    p = jnp.arange(W, dtype=jnp.int32)

    def off_of(i, t_len, rl):
        c = (i * rl) // jnp.maximum(t_len, 1)
        return jnp.clip(c - W // 2, -W // 2, jnp.maximum(rl - W // 2, 0))

    def one(template, t_len, reads_v, read_lens_v):
        off0 = off_of(jnp.int32(0), t_len, read_lens_v)
        j0 = off0[:, None] + p[None, :]
        valid0 = (j0 >= 0) & (j0 <= read_lens_v[:, None])
        D0 = jnp.where(valid0, 0 if not global_ends else j0, _INF).astype(jnp.int32)
        best0 = jnp.full((N,), _INF, dtype=jnp.int32)

        def body(carry, i):
            D_prev, off_prev, best_end = carry
            off = off_of(i, t_len, read_lens_v)
            s = (off - off_prev)[:, None]
            idx = p[None, :] + s
            ok = (idx >= 0) & (idx < W)
            E = jnp.where(ok, jnp.take_along_axis(D_prev, jnp.clip(idx, 0, W - 1), axis=1), _INF)
            idx1 = idx - 1
            ok1 = (idx1 >= 0) & (idx1 < W)
            E1 = jnp.where(ok1, jnp.take_along_axis(D_prev, jnp.clip(idx1, 0, W - 1), axis=1), _INF)
            j = off[:, None] + p[None, :]
            t_ch = template[i - 1]
            r_ch = jnp.take_along_axis(reads_v, jnp.clip(j - 1, 0, RL - 1), axis=1)
            sub = (r_ch != t_ch).astype(jnp.int32)
            diag = jnp.where(j >= 1, E1 + sub, _INF)
            up = E + 1
            if not global_ends:
                up = jnp.where(j == 0, jnp.minimum(up, 0), up)
            tmp = jnp.minimum(diag, up)
            closed = jax.lax.associative_scan(jnp.minimum, tmp - p[None, :], axis=1)
            D = closed + p[None, :]
            valid = (j >= 0) & (j <= read_lens_v[:, None]) & (i <= t_len)
            D = jnp.where(valid, jnp.minimum(D, _INF), _INF)
            if global_ends:
                at_end = jnp.where(
                    (j == read_lens_v[:, None]) & valid & (i == t_len), D, _INF
                ).min(axis=1)
            else:
                at_end = jnp.where((j == read_lens_v[:, None]) & valid, D, _INF).min(axis=1)
            best_end = jnp.minimum(best_end, at_end)
            return (D, off, best_end), jnp.where(i == t_len, D, _INF).min(axis=1)

        rows = jnp.arange(1, T + 1, dtype=jnp.int32)
        (D_last, _, best_end), row_last = jax.lax.scan(body, (D0, off0, best0), rows)
        if global_ends:
            return best_end
        d_t_end = row_last.min(axis=0)
        return jnp.minimum(best_end, d_t_end)

    return jax.vmap(one)(templates, t_lens, reads, read_lens)


#: polish-scorer lane buckets: two V widths and four read-count widths —
#: EIGHT compiled shapes total, most runs touching one or two
_V_SMALL, _V_MAX = 512, 8192
_N_BUCKETS = [8, 32, 64, 128]


@functools.partial(jax.jit, static_argnames=("TW", "TWp", "RW", "NB"))
def _nw_dist_pair_packed(chars_pack, meta, TW: int, TWp: int, RW: int,
                         NB: int):
    """Paired gain scorer: ONE 2-bit transfer carries each candidate's
    base window, edited window, and read segments — the segments (the
    bulk: NB·RW of the TWp + TWp + NB·RW chars) are shipped ONCE and
    scored against both templates on device (the former one-variant
    layout duplicated every segment across the base/edit lane halves,
    doubling the stage's staging bytes).

    ``chars_pack`` (V, (2·TWp + NB·RW)/4) uint8 = [base window | edited
    window | NB read windows], 2-bit packed; ``meta`` (V, 2 + NB) int32
    = [wlen, elen, rwin_len...] (row-major so the lane axis shards
    cleanly under ``shard_map``).  Returns (2, V, NB) int32: base and
    edit distances.
    """
    from .banded import _unpack2bit

    V = meta.shape[0]
    buf = _unpack2bit(chars_pack)  # (V, 2*TWp + NB*RW)
    win = buf[:, :TW]
    ewin = buf[:, TWp : TWp + TW]
    rwin = buf[:, 2 * TWp :].reshape(V, NB, RW)
    rl = meta[:, 2:]
    tpl2 = jnp.concatenate([win, ewin], axis=0)
    tl2 = jnp.concatenate([meta[:, 0], meta[:, 1]])
    reads2 = jnp.concatenate([rwin, rwin], axis=0)
    rl2 = jnp.concatenate([rl, rl], axis=0)
    out = _nw_dist_full(tpl2, tl2, reads2, rl2, T=TW, global_ends=True)
    return out.reshape(2, V, NB)


#: compiled sharded polish scorers keyed by (mesh devices, shape)
_SHARDED_DIST_CACHE: dict = {}


def _sharded_nw_dist(mesh, TW: int, TWp: int, RW: int, NB: int):
    """:func:`_nw_dist_pair_packed` under ``shard_map``: candidate lanes
    shard on ``dp``, per-lane distances are allgathered (identical to the
    single-device result; the gather runs on axis 1 — the lane axis of
    the (2, V, NB) result — so base/edit halves stay contiguous)."""
    key = (tuple(d.id for d in mesh.devices.flat), TW, TWp, RW, NB)
    fn = _SHARDED_DIST_CACHE.get(key)
    if fn is not None:
        return fn
    from jax.sharding import PartitionSpec as P

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("dp", None), P("dp", None)),
        out_specs=P(),
        check_vma=False,
    )
    def step(chars_pack, meta):
        out = _nw_dist_pair_packed(chars_pack, meta, TW=TW, TWp=TWp, RW=RW,
                                   NB=NB)
        return jax.lax.all_gather(out, "dp", axis=1, tiled=True)

    _SHARDED_DIST_CACHE[key] = step
    return step


def _n_bucket(n: int) -> int:
    for b in _N_BUCKETS:
        if n <= b:
            return b
    return _N_BUCKETS[-1]


def _assemble_gain_group(template, pos, kind, base, reads_arr, jpath,
                         NB: int, HALF: int, RW: int, TW: int):
    """Vectorized window assembly for one pile-up's candidate edits.

    Returns (win (K, TW), wlen, ewin (K, TW), elen, seg (K, NB, RW),
    seglen (K, NB), ok (K, NB)) — the per-candidate base and edited
    template windows plus each read's path-anchored segment.  The former
    per-candidate-per-read Python loop was a measured 2.2 s/run host
    hotspot.
    """
    K = len(pos)
    T = len(template)
    n = min(reads_arr.shape[0], NB)
    lo = np.maximum(pos - HALF, 0)
    hi = np.minimum(pos + HALF, T)
    wlen = hi - lo
    ar = np.arange(TW, dtype=np.int64)
    c = ar[None, :]
    idx = lo[:, None] + c
    win = np.where(c < wlen[:, None],
                   template[np.minimum(idx, max(T - 1, 0))], 0).astype(np.uint8)
    d = (pos - lo)[:, None]
    k2 = kind[:, None]
    # edited-window source columns: deletion skips d, insertion shifts
    # right of d (d itself overwritten with the base), substitution copies
    src = np.where(k2 == 0, np.where(c < d, c, c + 1),
                   np.where(k2 == 1, np.where(c <= d, c, c - 1), c))
    ewin = np.take_along_axis(win, np.minimum(src, TW - 1), axis=1)
    at_d = (c == d) & (k2 != 0)
    ewin = np.where(at_d, base[:, None], ewin).astype(np.uint8)
    elen = wlen + (kind == 1).astype(np.int64) - (kind == 0).astype(np.int64)
    ewin = np.where(c < elen[:, None], ewin, 0).astype(np.uint8)

    seg = np.zeros((K, NB, RW), dtype=np.uint8)
    seglen = np.zeros((K, NB), dtype=np.int64)
    ok = np.zeros((K, NB), dtype=bool)
    if n:
        jlo = jpath[:n, lo].T  # (K, n)
        jhi = jpath[:n, hi].T
        ok_n = (jlo >= 0) & (jhi > jlo) & (jhi - jlo <= RW)
        sl = np.where(ok_n, jhi - jlo, 0)
        RL = reads_arr.shape[1]
        ridx = np.clip(jlo[:, :, None], 0, RL - 1) + np.arange(RW)[None, None, :]
        mask = np.arange(RW)[None, None, :] < sl[:, :, None]
        seg[:, :n] = np.where(
            mask, reads_arr[np.arange(n)[None, :, None],
                            np.clip(ridx, 0, RL - 1)], 0)
        seglen[:, :n] = sl
        ok[:, :n] = ok_n
    return win, wlen, ewin, elen, seg, seglen, ok


def _window_gains_multi(groups, W_score: int = 16, HALF: int = 16, mesh=None):
    """Score candidate edits on path-anchored local windows, batched
    across pile-ups.

    groups: list of (template, pos (K,), kind (K,), base (K,),
    reads_arr, jpath) — one entry per pile-up, so one dispatch mixes
    candidates from many pile-ups.  Both the unedited and edited window
    are scored with a *global* NW against each read's segment between
    its traceback-path coordinates at the window boundaries (anchored
    ends — free ends would let deletions hide in unpenalized gaps).
    Returns flat gains in group order: Σ_reads (base − edit).
    """
    from .banded import _pack2bit

    TW = 2 * HALF + 2
    # read-window capacity: segments span ~TW·(1+err) chars (measured
    # p99 = 38 at 13 % error for TW=34); W_score slack absorbs the tail,
    # and longer segments are skipped (ok stays False) — they imply
    # a local blow-up the ±1-edit score can't judge anyway
    RW = 2 * HALF + W_score
    TWp = -(-TW // 4) * 4

    # groups bucket by THEIR read count (a lone 36-read pile-up must not
    # force every other group onto 128 padded read slots)
    counts = [len(g[1]) for g in groups]
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    gains_all = np.zeros(int(offsets[-1]), dtype=np.int64)
    by_nb: dict[int, list[int]] = {}
    for gi, g in enumerate(groups):
        if len(g[1]):
            by_nb.setdefault(_n_bucket(g[4].shape[0]), []).append(gi)
    if not by_nb:
        return gains_all

    inflight = []
    from concurrent.futures import ThreadPoolExecutor

    _t_g = time.perf_counter()
    for NB, gidx in by_nb.items():
        # per-group window assembly is independent numpy; thread it
        # (the serial loop was ~10 s/run at 147-pile-up scale)
        with ThreadPoolExecutor(max_workers=4) as ex:
            parts = list(ex.map(
                lambda gi: _assemble_gain_group(*groups[gi][:6], NB, HALF,
                                                RW, TW), gidx))
        WIN = np.concatenate([p[0] for p in parts])
        WLEN = np.concatenate([p[1] for p in parts])
        EWIN = np.concatenate([p[2] for p in parts])
        ELEN = np.concatenate([p[3] for p in parts])
        SEG = np.concatenate([p[4] for p in parts])
        SLEN = np.concatenate([p[5] for p in parts])
        OK = np.concatenate([p[6] for p in parts])
        # flat output positions of this class's candidates
        dst = np.concatenate([np.arange(offsets[gi], offsets[gi + 1])
                              for gi in gidx])
        Ktot = len(WIN)
        for c0 in range(0, Ktot, _V_MAX // 2):
            n_chunk = min(_V_MAX // 2, Ktot - c0)
            # two V widths only (see _V_SMALL): every chunk reuses a
            # compiled shape instead of minting per-power-of-2 variants
            V = _V_SMALL // 2 if n_chunk <= _V_SMALL // 2 else _V_MAX // 2
            if mesh is not None and mesh.size > 1 and V % mesh.size:
                V = -(-V // mesh.size) * mesh.size  # non-power-of-2 meshes
            buf = np.zeros((V, 2 * TWp + NB * RW), dtype=np.uint8)
            meta = np.zeros((V, 2 + NB), dtype=np.int32)
            sl = slice(c0, c0 + n_chunk)
            buf[:n_chunk, :TW] = WIN[sl]
            buf[:n_chunk, TWp : TWp + TW] = EWIN[sl]
            buf[:n_chunk, 2 * TWp :] = SEG[sl].reshape(n_chunk, NB * RW)
            meta[:n_chunk, 0] = WLEN[sl]
            meta[:n_chunk, 1] = ELEN[sl]
            meta[:n_chunk, 2:] = SLEN[sl]
            if mesh is not None and mesh.size > 1:
                from jax.sharding import PartitionSpec as P

                from ..parallel.dp import stage_global

                out = _sharded_nw_dist(mesh, TW, TWp, RW, NB)(
                    stage_global(mesh, P("dp", None), _pack2bit(buf)),
                    stage_global(mesh, P("dp", None), meta))
            else:
                out = _nw_dist_pair_packed(
                    jnp.asarray(_pack2bit(buf)), jnp.asarray(meta),
                    TW=TW, TWp=TWp, RW=RW, NB=NB,
                )
            inflight.append((dst[sl], OK[sl], n_chunk, out))

    prof_add("cons.gains.assemble+enqueue",
             time.perf_counter() - _t_g)
    with prof("cons.gains.fetch"):
        with ThreadPoolExecutor(max_workers=4) as ex:
            fetched = list(ex.map(lambda t: np.asarray(t[3]), inflight))
    for (dst_c, ok_c, n_chunk, _out), dist in zip(inflight, fetched):
        db = dist[0, :n_chunk]
        de = dist[1, :n_chunk]
        okc = ok_c & (db < _INF) & (de < _INF)
        gains_all[dst_c] = np.where(okc, db - de, 0).sum(axis=1)
    return gains_all


def _candidates_from_votes(col_votes, ins_votes, cov, min_votes_frac=0.08,
                           floor_high=3, template=None):
    """Candidate single-base edits: (pos, kind, base); kind 0=del, 1=ins,
    2=substitution.

    The vote floor matters for cost, not just noise: at 13 % error and
    20× coverage a 2-vote floor qualifies ~every column (P[≥2 noise
    votes] ≈ 0.26), making the polish scorer scan the whole template
    every round.  ``floor_high`` applies at ≥12× coverage: 3 for the
    fast early rounds, lowered to 2 by the polish loop's final
    refinement pass — real edits occasionally sit at 2 votes even at
    20× (error-masked in most reads), so the 2-vote fixpoint decides
    byte-exactness.  Below 12× the floor is always 2 (real edits can be
    thin there and noise floods are no concern: P[≥2] ≈ 0.06 at 8×).
    """
    T = col_votes.shape[0]
    floor = np.where(cov >= 12, floor_high, 2)
    min_votes = np.maximum((min_votes_frac * np.maximum(cov, 1)).astype(int),
                           floor)
    candidates: list[tuple[int, int, int]] = []
    for i in np.flatnonzero(col_votes[:, 4] >= min_votes):
        candidates.append((int(i), 0, 0))
    thresh = min_votes[np.clip(np.arange(T + 1) - 1, 0, T - 1)][:, None, None]
    ins_pos, ins_rank, ins_base = np.nonzero(ins_votes >= thresh)
    for i, r, b in zip(ins_pos, ins_rank, ins_base):
        if r == 0:
            candidates.append((int(i), 1, int(b)))
    if template is not None and T:
        # substitution candidates: a non-template base whose column vote
        # is a strong runner-up.  Per-column majority already picked the
        # argmax, but reads with indels near the column scatter their
        # votes across neighbors — the exact window objective re-aligns
        # each read locally and can overturn a misvoted column (the
        # residual-error class votes alone never fix)
        # templates are 2-bit codes by construction; clip defensively so
        # an N/pad code (≥ 4) reaching this boundary cannot fault the
        # polish loop (it would merely skip that column's substitution)
        cur = np.minimum(template[:T].astype(np.int64), 3)
        v = col_votes[:, :4].copy()
        cur_votes = v[np.arange(T), cur]
        v[np.arange(T), cur] = -1
        alt = v.argmax(axis=1)
        alt_votes = v[np.arange(T), alt]
        sel = (alt_votes >= min_votes) & (2 * alt_votes >= cur_votes)
        for i in np.flatnonzero(sel):
            candidates.append((int(i), 2, int(alt[i])))
    return candidates


#: columns within this distance of an applied edit are realigned (the
#: windowed kernel's margins absorb the path wander one edit can cause)
_EDIT_PAD = _MARGIN + 2


def _apply_edits(template: np.ndarray, chosen):
    """Apply spaced single-base edits (descending position order).

    Returns ``(new_template, src_bnd, src_col)``: boundary/column maps
    from new coordinates to old (``src_col[i] = -1`` for inserted
    columns) — the exact correspondence that lets traceback paths, vote
    matrices, and cached gains follow template edits.
    """
    src_bnd = np.arange(len(template) + 1, dtype=np.int64)
    src_col = np.arange(len(template), dtype=np.int64)
    for pos, kind, base in sorted(chosen, reverse=True):
        if kind == 0:
            template = np.delete(template, pos)
            src_bnd = np.delete(src_bnd, pos)
            src_col = np.delete(src_col, pos)
        elif kind == 1:
            template = np.insert(template, pos, base)
            src_bnd = np.insert(src_bnd, pos, src_bnd[pos])
            src_col = np.insert(src_col, pos, -1)
        else:  # substitution (content change; position map unchanged)
            template = template.copy()
            template[pos] = base
    return template, src_bnd, src_col


def _remap_out(prev: _RoundOut, src_bnd: np.ndarray,
               src_col: np.ndarray) -> _RoundOut:
    """Carry a round's stitched arrays through template edits: copied
    columns keep their per-read values, inserted columns start uncovered
    (the dirty realign that follows fills them).  Derived stats
    (spans/diffs/win) go stale — the next realign recomputes them from
    the full stitched arrays."""
    sc = np.maximum(src_col, 0)
    sym = np.where(src_col[None, :] >= 0, prev.sym[:, sc], np.int8(5)).astype(np.int8)
    ins = prev.ins[:, src_bnd]
    jp = prev.jpath[:, src_bnd]
    return _RoundOut(sym, ins, jp, prev.spans, prev.diffs, prev.win,
                     prev.covered)


def _votes_refresh(votes, out: _RoundOut, T: int):
    """Update vote matrices in place on the round's fresh columns (or
    rebuild them wholly after a full round)."""
    if out.fresh_cols is None:
        return list(_votes_of(out, T))
    cv, iv, cov = votes
    cols = np.flatnonzero(out.fresh_cols)
    bnds = np.flatnonzero(out.fresh_bnds)
    if len(cols):
        cvc = (out.sym[:, cols, None]
               == np.arange(5, dtype=np.int8)).sum(axis=0).astype(np.int32)
        cv[cols] = cvc
        cov[cols] = cvc.sum(axis=1)
    if len(bnds):
        iv[bnds] = (out.ins[:, bnds, :, None]
                    == np.arange(1, 5, dtype=np.int8)).sum(axis=0).astype(np.int32)
    return [cv, iv, cov]


def _polish_batch(states, read_sets, W: int, max_rounds: int = 8, mesh=None,
                  tie_policy: str = "delete"):
    """Hill-climb on total edit distance to all reads, batched.

    Candidate edits (single-base insertions, deletions, substitutions)
    come from the vote matrices; an edit is kept only if it reduces the
    exact local objective.  This escapes the local fixpoints of
    per-column majority voting where 13 %-error reads scatter indel
    votes across neighboring columns (daccord's de-Bruijn window
    consensus solves the same problem).

    Cost model (the round-3 bench's 411 s lived here): every candidate's
    exact gain is scored ONCE and cached — candidate sets barely change
    between rounds, and the former per-round rescoring paid ~10× the
    unique-candidate work; after edits are applied, only windows around
    the edit sites realign (``_ConsJob.dirty``) and only their votes and
    nearby cached gains refresh.  All still-improving pile-ups share
    each round's dispatches.

    ``tie_policy`` decides edits whose exact objective TIES (gain 0):
    ``"delete"`` accepts deletions (insertion-biased error profiles:
    PacBio CLR ≈ 55 % ins / 25 % del — the default and what the
    simulator reproduces), ``"insert"`` accepts insertions
    (deletion-biased profiles, e.g. older ONT chemistries), ``"none"``
    rejects all ties.  daccord derives the same tilt from its measured
    error profile (``--eprofonly`` pre-pass, ``dazzler.d:4324``).
    """
    tie_kind = {"delete": 0, "insert": 1}.get(tie_policy)
    HALF = 16
    active = [p for p in range(len(states))
              if len(read_sets[p]) > 1 and len(states[p]["template"])]
    # refresh alignment state where the last rebuild left it stale
    stale = [p for p in active
             if states[p]["stats_stale"] or states[p]["last_out"] is None]
    if stale:
        jobs = [_ConsJob(states[p]["template"], read_sets[p],
                         states[p]["jpath"],
                         prev=(states[p]["last_out"]
                               if states[p].get("dirty") is not None else None),
                         dirty=states[p].get("dirty"),
                         reads_arr=states[p].get("reads_arr"),
                         seg_res=states[p].get("seg_res"),
                         read_offs=states[p].get("read_offs"))
                for p in stale]
        for ai, out in enumerate(_run_round(jobs, W, mesh=mesh)):
            p = stale[ai]
            states[p]["last_out"] = out
            states[p]["jpath"] = out.jpath
            states[p]["stats_stale"] = False
            states[p]["dirty"] = None

    votes = {p: list(_votes_of(states[p]["last_out"],
                               len(states[p]["template"]))) for p in active}
    caches: dict[int, dict] = {p: {} for p in active}
    # two-phase floors: rounds run with the 3-vote candidate floor until
    # a pile-up converges, then a floor-2 refinement catches the rare
    # thin-support true edits (byte-exactness).  The floor-2 flood
    # arrives when the template is nearly final — its cached gains
    # survive (the early rounds' dense edits would have invalidated most
    # of an up-front floor-2 scoring).
    floors = {p: 3 for p in active}

    for _rnd in range(max_rounds + 1):
        if not active:
            break
        # ---- candidates; score only cache misses (exact window gains)
        per_cands: dict[int, list] = {}
        groups, group_meta = [], []
        with prof("cons.polish.candidates"):
            for p in active:
                cv, iv, cov = votes[p]
                cands = _candidates_from_votes(cv, iv, cov,
                                               floor_high=floors[p],
                                               template=states[p]["template"])
                per_cands[p] = cands
                miss = [c for c in cands if c not in caches[p]]
                if miss:
                    ca = np.array(miss, dtype=np.int64).reshape(-1, 3)
                    groups.append((states[p]["template"], ca[:, 0], ca[:, 1],
                                   ca[:, 2], states[p]["reads_arr"],
                                   states[p]["jpath"]))
                    group_meta.append((p, miss))
        if groups:
            gains = _window_gains_multi(groups, HALF=HALF, mesh=mesh)
            gi = 0
            for p, miss in group_meta:
                for c in miss:
                    caches[p][c] = int(gains[gi])
                    gi += 1

        # ---- choose non-overlapping best edits; apply + remap
        edited: list[int] = []
        next_active: list[int] = []
        dirty_now: dict[int, np.ndarray] = {}
        _t_apply = time.perf_counter()
        for p in active:
            mine = sorted(((caches[p][c], c) for c in per_cands[p]),
                          key=lambda x: -x[0])
            chosen, taken_pos = [], []
            for g, (pos, kind, base) in mine:
                # Ties (g == 0) fall to the error-profile tilt: when the
                # exact objective cannot decide between "extra base is
                # real" and "extra base is k coinciding read insertions",
                # the profile's dominant error kind picks the likelier
                # explanation (see tie_policy in the docstring).
                if g < 0 or (g == 0 and kind != tie_kind):
                    continue
                if all(abs(pos - q) > 2 * HALF for q in taken_pos):
                    chosen.append((pos, kind, base))
                    taken_pos.append(pos)
            if not chosen:
                if floors[p] > 2:  # converged at floor 3: refine at 2
                    floors[p] = 2
                    next_active.append(p)
                continue
            st = states[p]
            T_old = len(st["template"])
            dirty_old = np.zeros(T_old, dtype=bool)
            for pos, _kind, _base in chosen:
                dirty_old[max(pos - _EDIT_PAD, 0)
                          : min(pos + _EDIT_PAD + 1, T_old)] = True
            new_template, src_bnd, src_col = _apply_edits(st["template"], chosen)
            T_new = len(new_template)
            sc = np.maximum(src_col, 0)
            st["template"] = new_template
            st["last_out"] = _remap_out(st["last_out"], src_bnd, src_col)
            st["jpath"] = st["last_out"].jpath
            st["stats_stale"] = True
            dirty_new = np.where(src_col >= 0, dirty_old[sc], True)
            dirty_now[p] = dirty_new
            # votes follow the column map (dirty rows refresh post-realign)
            cv, iv, cov = votes[p]
            votes[p] = [
                np.where((src_col >= 0)[:, None], cv[sc], 0).astype(np.int32),
                iv[src_bnd],
                np.where(src_col >= 0, cov[sc], 0).astype(np.int32),
            ]
            # cached gains follow the position maps; anything near an
            # edit is invalidated (template content + paths change there)
            invalid = _dilate_mask(dirty_new, HALF + 1)
            new_of_col = np.full(T_old, -1, dtype=np.int64)
            m = src_col >= 0
            new_of_col[src_col[m]] = np.flatnonzero(m)
            new_of_bnd = np.full(T_old + 1, -1, dtype=np.int64)
            new_of_bnd[src_bnd] = np.arange(T_new + 1)
            cache_new = {}
            for (pos, kind, base), g in caches[p].items():
                np_ = (new_of_bnd[pos] if kind == 1
                       else (new_of_col[pos] if pos < T_old else -1))
                if np_ >= 0 and not invalid[min(np_, T_new - 1)]:
                    cache_new[(int(np_), kind, base)] = g
            caches[p] = cache_new
            edited.append(p)
            next_active.append(p)
        prof_add("cons.polish.apply",
                 time.perf_counter() - _t_apply)

        # ---- realign only the windows the edits touched
        if edited:
            jobs = [_ConsJob(states[p]["template"], read_sets[p],
                             states[p]["jpath"], prev=states[p]["last_out"],
                             dirty=dirty_now[p],
                             reads_arr=states[p]["reads_arr"],
                         seg_res=states[p].get("seg_res"),
                         read_offs=states[p].get("read_offs"))
                    for p in edited]
            for ai, out in enumerate(_run_round(jobs, W, mesh=mesh)):
                p = edited[ai]
                states[p]["last_out"] = out
                states[p]["jpath"] = out.jpath
                states[p]["stats_stale"] = False
                votes[p] = _votes_refresh(votes[p], out,
                                          len(states[p]["template"]))
                if out.fresh_cols is not None and out.fresh_cols.any():
                    inv = _dilate_mask(out.fresh_cols, HALF + 1)
                    caches[p] = {k: v for k, v in caches[p].items()
                                 if not inv[min(k[0], len(inv) - 1)]}
        active = next_active


# ======================================================================
# Shape warming
# ======================================================================

_WARM_STARTED = False


def warm_shapes(W: int = 128, max_workers: int = 4) -> None:
    """Compile every consensus device program in background threads.

    The process stage dispatches ~30 distinct shapes; compiled lazily,
    each first use would stall a round boundary.  Firing every shape at
    pipeline start overlaps the compiles (or cache loads) with data
    loading, seeding and mapping.  Built for the former remote
    backend's per-program loads; whether it pays on the GPU is
    unmeasured.  No-op on CPU backends; fire-and-forget, and a failing
    task is logged as a ``warmFailed`` event.
    """
    global _WARM_STARTED
    if _WARM_STARTED or not _is_accel():
        return
    _WARM_STARTED = True
    import threading

    def _full(TB, N):
        RLB = _rl_bucket(0, TB)
        chars = np.zeros((N, TB // 4 + RLB // 4 + TB // 4), np.uint8)
        meta = np.zeros(3 * N, np.int32)
        meta[:N] = 1
        # the production round: sparse result block
        np.asarray(_nw_round_packed_sparse(
            jnp.asarray(chars), jnp.asarray(meta), T=TB, RL=RLB, W=W,
            S=TB + RLB, NWIN=max(TB_nwin(TB), 1)))

    def _windowed():
        # production order: the arena-resident sparse kernel first (all
        # windowed rounds), then the lane-shipped sparse variant
        # (non-resident fallback)
        from .banded import ARENA

        N = _WCHUNK
        with ARENA.lock:
            ARENA._ensure()
            arena = ARENA.array
        meta5 = np.zeros((5, N), np.int32)
        meta5[0] = 1
        np.asarray(_nw_window_round_resident(arena, jnp.asarray(meta5), W=W))
        chars = np.zeros((N, _WS // 4 + _SEG // 4 + _WS // 4), np.uint8)
        meta = np.zeros((4, N), np.int32)
        meta[0] = 1
        np.asarray(_nw_window_round_sparse(jnp.asarray(chars),
                                           jnp.asarray(meta), W=W))

    def _gains(V, NB):
        # the fixed _window_gains_multi geometry: HALF=16, W_score=16
        TW, TWp, RW = 34, 36, 48
        chars = np.zeros((V, (2 * TWp + NB * RW) // 4), np.uint8)
        meta = np.zeros((V, 2 + NB), np.int32)
        np.asarray(_nw_dist_pair_packed(jnp.asarray(chars),
                                        jnp.asarray(meta),
                                        TW=TW, TWp=TWp, RW=RW, NB=NB))

    tasks = [(_windowed,)]
    for TB in _T_BUCKETS:
        tasks.append((_full, TB, _n_max(TB, W)))
    for NB in _N_BUCKETS:
        tasks.append((_gains, _V_MAX // 2, NB))
    for NB in _N_BUCKETS:
        tasks.append((_gains, _V_SMALL // 2, NB))
    for TB in _T_BUCKETS:
        tasks.append((_full, TB, _N_LADDER[0]))

    def _go():
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=max_workers) as ex:
            for t in tasks:
                ex.submit(_safe, *t)

    def _safe(fn, *a):
        try:
            fn(*a)
        except Exception as exc:  # a warm failure must not stop the run
            log_json("warn", event="warmFailed", task=fn.__name__,
                     args=list(a), error=repr(exc))

    threading.Thread(target=_go, daemon=True, name="dentist-warm-cons").start()


# ======================================================================
# Public API
# ======================================================================


@dataclass
class ConsensusResult:
    sequence: np.ndarray  # consensus codes
    coverage: np.ndarray  # per consensus window: number of covering reads
    read_spans: np.ndarray  # (N, 2) template interval covered per read
    read_diffs: np.ndarray  # (N,) total diffs vs final consensus
    win_diffs: np.ndarray  # (N, n_windows) per-126bp-window diffs (QV signal)


def _result_from(template, out: _RoundOut) -> ConsensusResult:
    T = len(template)
    n_win = max(TB_nwin(T), 1)
    win_cov = np.zeros(n_win, dtype=np.int32)
    for b, e in out.spans:
        wb, we = int(b) // TRACE_SPACING, (max(int(e) - 1, 0)) // TRACE_SPACING
        if e > b:
            win_cov[wb : we + 1] += 1
    return ConsensusResult(template, win_cov, out.spans, out.diffs, out.win)


def _trivial_result(reads: list[np.ndarray]) -> ConsensusResult | None:
    if not reads:
        return ConsensusResult(np.empty(0, np.uint8), np.empty(0, np.int32),
                               np.empty((0, 2), np.int64), np.empty(0, np.int64),
                               np.empty((0, 0), np.int32))
    if len(reads) == 1:
        seq = reads[0]
        return ConsensusResult(seq, np.ones(1, np.int32),
                               np.array([[0, len(seq)]]), np.zeros(1, np.int64),
                               np.zeros((1, 1), np.int32))
    return None


def consensus_batch(read_sets: list[list[np.ndarray]], rounds: int = 3,
                    W: int = 128, template_idxs: list[int | None] | None = None,
                    polish: bool = True, mesh=None,
                    tie_policy: str = "delete") -> list[ConsensusResult]:
    """Compute consensi for MANY pile-ups; dispatches are shared.

    Each realign round batches the lanes of every still-active pile-up
    into a handful of bucketed device programs (the reference
    thread-parallelizes pile-ups, ``processPileUps/package.d:153``; here
    they share dispatches instead).  With ``mesh`` (>1 device) every
    dispatch runs data-parallel over the mesh's ``dp`` axis with
    allgathered per-lane outputs — the mesh-parallel process stage
    (SURVEY §2.4; ``snakemake/Snakefile:1315-1358`` batch slices).
    """
    read_sets = [[np.asarray(r, dtype=np.uint8) for r in rs if len(r) > 0]
                 for rs in read_sets]
    results: list[ConsensusResult | None] = [None] * len(read_sets)
    # device-resident cropped-read store: ONE packed arena upload serves
    # every windowed realign round of the whole batch (the per-lane read
    # segments were the rounds' largest input stream)
    seg_res = None
    read_offs: list[np.ndarray | None] = [None] * len(read_sets)
    if (mesh is None or mesh.size <= 1) and not os.environ.get(
            "DENTIST_TPU_DENSE_CONS"):
        offs_all, pos = [], 0
        for rs in read_sets:
            job_offs = np.empty(len(rs), np.int64)
            for i, r in enumerate(rs):
                job_offs[i] = pos
                pos += len(r)
            offs_all.append(job_offs)
        if pos:
            try:
                seg_res = _ArenaRef(
                    np.concatenate([r for rs in read_sets for r in rs]))
                read_offs = offs_all
            except MemoryError as exc:
                # host-window dispatch (identical results)
                log_json("warn", event="arenaFallback", stage="consensus",
                         error=str(exc))
                seg_res = None
    states: list[dict] = []
    for p, reads in enumerate(read_sets):
        triv = _trivial_result(reads)
        t_idx = template_idxs[p] if template_idxs else None
        if triv is not None:
            results[p] = triv
            template = np.empty(0, np.uint8)
        else:
            if t_idx is None:
                order = sorted(range(len(reads)), key=lambda i: len(reads[i]))
                t_idx = order[len(order) // 2]
            template = reads[t_idx]
        RL = max((len(r) for r in reads), default=1)
        reads_arr = np.zeros((len(reads), RL), dtype=np.uint8)
        for n, r in enumerate(reads):
            reads_arr[n, : len(r)] = r
        states.append({"template": template, "jpath": None, "done": False,
                       "last_out": None, "stats_stale": False,
                       "reads_arr": reads_arr, "dirty": None,
                       "seg_res": seg_res, "read_offs": read_offs[p]})

    live = [p for p in range(len(read_sets)) if results[p] is None]
    for rnd in range(rounds):
        active = [p for p in live if not states[p]["done"]
                  and len(states[p]["template"])]
        if not active:
            break
        # rounds after a rebuild realign only windows the rebuild touched
        # (``dirty`` from ``_rebuild_maps``); the late rounds, where the
        # template is nearly converged, cost O(changes) instead of O(T)
        jobs = [_ConsJob(states[p]["template"], read_sets[p],
                         states[p]["jpath"],
                         prev=(states[p]["last_out"]
                               if states[p]["dirty"] is not None else None),
                         dirty=states[p]["dirty"],
                         reads_arr=states[p]["reads_arr"],
                         seg_res=states[p].get("seg_res"),
                         read_offs=states[p].get("read_offs"))
                for p in active]
        outs = _run_round(jobs, W, mesh=mesh)
        for ai, p in enumerate(active):
            st = states[p]
            T = len(st["template"])
            col_votes, ins_votes, cov = _votes_of(outs[ai], T)
            st["jpath"] = outs[ai].jpath
            st["last_out"] = outs[ai]
            new_template, src_bnd = _rebuild_template(st["template"],
                                                      col_votes, ins_votes, cov)
            if len(new_template) == len(st["template"]) and np.array_equal(
                    new_template, st["template"]):
                st["done"] = True
                st["stats_stale"] = False
                st["dirty"] = None
            else:
                src_col, dirty = _rebuild_maps(st["template"], new_template,
                                               src_bnd)
                st["template"] = new_template
                # exact remap: boundary c of the new template maps to
                # source boundary src_bnd[c] of the old one
                st["last_out"] = _remap_out(outs[ai], src_bnd, src_col)
                st["jpath"] = st["last_out"].jpath
                st["dirty"] = _dilate_mask(dirty, _EDIT_PAD)
                st["stats_stale"] = True

    if polish:
        _polish_batch([states[p] for p in live],
                      [read_sets[p] for p in live], W, mesh=mesh,
                      tie_policy=tie_policy)

    # refresh stats for pile-ups whose template changed after their last round
    stale = [p for p in live if states[p]["stats_stale"]
             and len(states[p]["template"])]
    if stale:
        jobs = [_ConsJob(states[p]["template"], read_sets[p],
                         states[p]["jpath"],
                         prev=(states[p]["last_out"]
                               if states[p]["dirty"] is not None else None),
                         dirty=states[p]["dirty"],
                         reads_arr=states[p]["reads_arr"],
                         seg_res=states[p].get("seg_res"),
                         read_offs=states[p].get("read_offs"))
                for p in stale]
        outs = _run_round(jobs, W, mesh=mesh)
        for ai, p in enumerate(stale):
            states[p]["last_out"] = outs[ai]
            states[p]["stats_stale"] = False

    for p in live:
        st = states[p]
        if st["last_out"] is None or len(st["template"]) == 0:
            results[p] = ConsensusResult(
                st["template"], np.zeros(1, np.int32),
                np.zeros((len(read_sets[p]), 2), np.int64),
                np.zeros(len(read_sets[p]), np.int64),
                np.zeros((len(read_sets[p]), 1), np.int32))
        else:
            results[p] = _result_from(st["template"], st["last_out"])
    return results


def consensus(reads: list[np.ndarray], rounds: int = 3, W: int = 128,
              template_idx: int | None = None, polish: bool = True,
              mesh=None, tie_policy: str = "delete") -> ConsensusResult:
    """Compute one pile-up's consensus (see :func:`consensus_batch`).

    ``tie_policy`` selects the error-profile tilt applied to
    cost-tied polish edits — ``"delete"`` (insertion-biased reads, the
    CLR default), ``"insert"`` (deletion-biased), or ``"none"``.
    """
    return consensus_batch([reads], rounds=rounds, W=W,
                           template_idxs=[template_idx], polish=polish,
                           mesh=mesh, tie_policy=tie_policy)[0]


def rank_reference_reads(win_diffs: np.ndarray, spans: np.ndarray,
                         bad_fraction: float = 0.8) -> np.ndarray:
    """Rank pile-up reads as consensus reference candidates.

    Mirrors ``findReferenceReadCandidates``
    (``processPileUps/package.d:518-568``): the intrinsic-QV histogram's
    value at cumulative ``bad_fraction`` becomes the bad-window
    threshold; reads are ordered by (number of bad windows, mean QV).
    Windows outside a read's covered span are ignored.
    """
    n, n_win = win_diffs.shape
    if n == 0:
        return np.empty(0, dtype=np.int64)
    wb = spans[:, 0] // TRACE_SPACING
    we = np.maximum(spans[:, 1] - 1, 0) // TRACE_SPACING
    cols = np.arange(n_win)[None, :]
    in_span = (cols >= wb[:, None]) & (cols <= we[:, None]) & (
        spans[:, 1] > spans[:, 0])[:, None]
    vals = win_diffs[in_span]
    if len(vals) == 0:
        return np.argsort(np.zeros(n), kind="stable")
    bad_qv = np.quantile(vals, bad_fraction)
    n_bad = ((win_diffs >= max(bad_qv, 1)) & in_span).sum(axis=1)
    denom = np.maximum(in_span.sum(axis=1), 1)
    mean_qv = win_diffs.sum(axis=1, where=in_span) / denom
    mean_qv = np.where(in_span.any(axis=1), mean_qv, np.inf)
    return np.lexsort((mean_qv, n_bad))
