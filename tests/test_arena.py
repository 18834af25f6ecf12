"""Device sequence arena semantics (ops/banded._Arena).

The round-5 review found the failure modes these tests pin down:
bump-allocation must hand out non-overlapping regions whose contents
read back exactly; a reset (arena full) must bump the epoch so offset
holders re-upload; a store too large for an empty arena must raise
(callers fall back to host-window dispatch, logged as ``arenaFallback``,
with identical results).
"""

import numpy as np
import pytest

import dentist_tpu.ops.banded as B


@pytest.fixture
def small_arena(monkeypatch):
    # ~3 write chunks above the mandatory pads: forces resets quickly
    cap = 2 * B.RESIDENT_PAD + 3 * B._ARENA_CHUNK
    monkeypatch.setattr(B, "_arena_capacity", lambda: cap)
    return B._Arena()


def _fetch(arena, off, n):
    return np.asarray(arena.array[off : off + n])


def test_uploads_read_back_and_do_not_overlap(small_arena):
    a = small_arena
    rng = np.random.default_rng(0)
    s1 = rng.integers(0, 4, 1000).astype(np.uint8)
    s2 = rng.integers(0, 4, 2000).astype(np.uint8)
    o1 = a.offset_of(s1)
    o2 = a.offset_of(s2)
    assert o1 >= B.RESIDENT_PAD
    assert o2 >= o1 + len(s1)
    assert np.array_equal(_fetch(a, o1, len(s1)), s1)
    assert np.array_equal(_fetch(a, o2, len(s2)), s2)
    # cached: same object returns the same offset without re-upload
    assert a.offset_of(s1) == o1


def test_reset_bumps_epoch_and_reuploads(small_arena):
    a = small_arena
    rng = np.random.default_rng(1)
    s1 = rng.integers(0, 4, B._ARENA_CHUNK).astype(np.uint8)
    e0 = a.epoch
    a.offset_of(s1)
    # fill until a reset must happen
    stores = []
    for i in range(4):
        s = rng.integers(0, 4, B._ARENA_CHUNK).astype(np.uint8)
        stores.append(s)
        a.offset_of(s, cache=False)
    assert a.epoch > e0, "filling past capacity must reset"
    # the cached store was evicted by the reset; re-request re-uploads
    # at a fresh offset with intact content
    o1b = a.offset_of(s1)
    assert np.array_equal(_fetch(a, o1b, len(s1)), s1)


def test_oversized_store_raises(small_arena):
    a = small_arena
    big = np.zeros(4 * B._ARENA_CHUNK, np.uint8)
    with pytest.raises(MemoryError):
        a.offset_of(big)


def _no_store_fits(monkeypatch, arena):
    """Route every resident upload to ``arena`` with room for no store."""
    monkeypatch.setattr(B, "ARENA", arena)
    monkeypatch.setattr(B, "_arena_capacity",
                        lambda: 2 * B.RESIDENT_PAD + B._ARENA_CHUNK - 1)


def test_consensus_arena_fallback_is_logged_and_exact(small_arena, monkeypatch):
    import dentist_tpu.ops.consensus as C
    from dentist_tpu.sim.reads import _mutate

    rng = np.random.default_rng(7)
    truth = rng.integers(0, 4, 700).astype(np.uint8)
    reads = [_mutate(truth, rng, 0.1) for _ in range(7)]
    ref = C.consensus_batch([reads])[0]
    events = []
    monkeypatch.setattr(C, "log_json", lambda level, **kw: events.append(kw))
    _no_store_fits(monkeypatch, small_arena)
    got = C.consensus_batch([reads])[0]
    assert [(e["event"], e["stage"]) for e in events] == [
        ("arenaFallback", "consensus")]
    assert np.array_equal(got.sequence, ref.sequence)
    assert np.array_equal(got.win_diffs, ref.win_diffs)


def test_extension_arena_fallback_is_logged_and_exact(small_arena,
                                                      monkeypatch):
    import dentist_tpu.ops.aligner as A
    from dentist_tpu.sim.genome import random_genome
    from dentist_tpu.sim.reads import simulate_reads

    genome = random_genome(30_000, seed=3)
    reads, _ = simulate_reads([genome], coverage=2, mean_length=5000,
                              sd_length=1000, error=0.1, seed=4)
    target = (genome, np.array([0]), np.array([len(genome)]))
    ref = A.align_store_pair(*target, reads)
    events = []
    monkeypatch.setattr(A, "log_json", lambda level, **kw: events.append(kw))
    _no_store_fits(monkeypatch, small_arena)
    got = A.align_store_pair(*target, reads)
    fallbacks = [e for e in events if e.get("event") == "arenaFallback"]
    assert fallbacks and all(e["stage"] == "extension" for e in fallbacks)
    assert len(got) == len(ref) > 0
    for f in ("a_id", "b_id", "a_begin", "a_end", "b_begin", "b_end",
              "diffs", "trace_diffs", "trace_b_adv"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
