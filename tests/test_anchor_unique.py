"""Unique-overlap flank anchoring: the reference requires a UNIQUE
proper overlap per flank when locating the contig edge in the consensus
(``getInsertionAlignment``, ``processPileUps/package.d:699-769``); a
repeat that contains a copy of the contig edge inside the gap must never
splice at the wrong position silently."""

import numpy as np

from dentist_tpu.models.process import AMBIGUOUS, _locate_anchor


def _rand(n, seed):
    return np.random.default_rng(seed).integers(0, 4, n).astype(np.uint8)


def test_unique_exact_hit():
    cons = _rand(600, 1)
    anchor = cons[100:164].copy()
    loc = _locate_anchor(cons, anchor, max_edits=8)
    assert loc == (100, 164, 0)


def test_duplicate_exact_hit_is_ambiguous():
    cons = _rand(600, 2)
    anchor = _rand(64, 3)
    cons[50:114] = anchor
    cons[400:464] = anchor  # second copy inside the gap repeat
    assert _locate_anchor(cons, anchor, max_edits=8) is AMBIGUOUS


def test_periodic_overlapping_hits_are_one_placement():
    # a homopolymer-ish anchor matches at adjacent shifts — one region
    cons = np.zeros(200, np.uint8)
    anchor = np.zeros(64, np.uint8)
    loc = _locate_anchor(cons, anchor, max_edits=8)
    assert loc is not AMBIGUOUS and loc is not None
    assert loc[2] == 0


def test_edit_tolerant_fallback_unique():
    cons = _rand(600, 4)
    anchor = cons[200:264].copy()
    anchor[10] = (anchor[10] + 1) % 4  # 1 substitution
    anchor = np.delete(anchor, 30)  # 1 deletion
    loc = _locate_anchor(cons, anchor, max_edits=8)
    assert loc is not None and loc is not AMBIGUOUS
    s, e, edits = loc
    assert edits == 2
    assert abs(s - 200) <= 2 and abs(e - 264) <= 2


def test_edit_tolerant_duplicate_is_ambiguous():
    cons = _rand(800, 5)
    probe = _rand(64, 6)
    for start in (100, 500):
        copy = probe.copy()
        copy[7] = (copy[7] + 1) % 4  # both copies near-exact
        cons[start : start + 64] = copy
    anchor = probe
    assert _locate_anchor(cons, anchor, max_edits=8) is AMBIGUOUS


def test_vectorized_fallback_matches_bruteforce():
    # edit distance of anchor vs every substring: compare against a
    # simple O(la*lc) reference DP (free leading/trailing cons gaps)
    rng = np.random.default_rng(7)
    for trial in range(10):
        cons = rng.integers(0, 4, 80).astype(np.uint8)
        anchor = rng.integers(0, 4, 12).astype(np.uint8)
        la, lc = len(anchor), len(cons)
        prev = np.zeros(lc + 1, dtype=np.int64)
        for i in range(1, la + 1):
            cur = np.empty(lc + 1, dtype=np.int64)
            cur[0] = i
            for j in range(1, lc + 1):
                cur[j] = min(prev[j - 1] + (cons[j - 1] != anchor[i - 1]),
                             prev[j] + 1, cur[j - 1] + 1)
            prev = cur
        best = int(prev.min())
        loc = _locate_anchor(cons, anchor, max_edits=la)
        if loc is AMBIGUOUS:
            continue  # random short anchors may legitimately tie
        assert loc is not None
        assert loc[2] == best


def test_repeat_edge_pileup_never_missplices():
    """End-to-end: a gap whose repeat interior contains a copy of the
    entering contig's gap-facing edge.  The pile-up must either close the
    gap byte-exactly or be skipped with a logged reason — never splice at
    the repeat copy."""
    from dentist_tpu.io.fasta import FastaRecord, codes_to_seq, seq_to_codes
    from dentist_tpu.models.sequences import SeqStore, split_scaffolds
    from dentist_tpu.pipeline import PipelineConfig, close_gaps
    from dentist_tpu.sim.genome import random_genome
    from dentist_tpu.sim.reads import simulate_reads

    rng = np.random.default_rng(70)
    left = random_genome(10_000, seed=71)
    right = random_genome(10_000, seed=72)
    edge = right[:300]  # entering contig's gap-facing edge
    filler = random_genome(400, seed=73)
    # gap interior contains a full copy of the edge before the real one
    gap_interior = np.concatenate([filler, edge, random_genome(300, seed=74)])
    truth = np.concatenate([left, gap_interior, right])

    seq = (codes_to_seq(left) + "n" * len(gap_interior) + codes_to_seq(right))
    records = [FastaRecord("scaf0", seq_to_codes(seq))]
    contigs, structure = split_scaffolds(records)
    assert len(structure.gaps) == 1

    read_list, _ = simulate_reads([truth], coverage=20, mean_length=8000,
                                  sd_length=2000, error=0.13, seed=75)
    reads = SeqStore(np.concatenate(read_list),
                     np.array([len(r) for r in read_list]),
                     [f"read{i+1}" for i in range(len(read_list))])

    result = close_gaps(contigs, structure, reads, read_list,
                        PipelineConfig(no_validation=True, read_coverage=20.0))
    out = "".join(s for _, s in result.records).lower()
    if result.n_closed_gaps == 1:
        assert out == codes_to_seq(truth).lower(), (
            "closed, so the splice must be byte-exact (no repeat-copy splice)")
    else:
        # skipped: the original gap must survive unchanged
        assert "n" in out
