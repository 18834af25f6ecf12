"""The reference example's scenario, self-hosted and scalable.

At ``mb=28`` it matches the reference example's scale: a 28 Mb genome
with 4 x 28 interspersed 3 kb repeats, 147 gaps of 100-1,000 bp, and
20x reads at 25 +- 12.5 kb with 13 % error (the example's ``gaps.bed``
has 147 rows on a 27,896,386 bp scaffold; its ``Makefile`` sets the read
model).  Smaller ``mb`` scales the repeats and gaps in proportion.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Example(NamedTuple):
    truth: np.ndarray  # the genome, 2-bit codes
    records: list  # the gapped assembly as FastaRecords
    contigs: object  # SeqStore of the contigs
    structure: object  # ScaffoldStructure (gaps, joins)
    reads: list  # per-read code arrays
    store: object  # SeqStore over ``reads``


def reference_example(mb: float = 28.0) -> Example:
    """Generate the scenario at ``mb`` megabases (fixed seeds)."""
    from ..io.fasta import FastaRecord
    from ..models.sequences import SeqStore, split_scaffolds
    from .genome import insert_repeats, random_genome
    from .partial import build_partial_assembly, random_gaps
    from .reads import simulate_reads

    size = int(mb * 1_000_000)
    g = random_genome(size, seed=321)
    g = insert_repeats(g, n_copies=max(1, int(4 * mb)), repeat_length=3000,
                       seed=322)
    gaps = random_gaps([g], n_gaps=max(1, round(147 * mb / 28)),
                       min_size=100, max_size=1000, margin=25_000, seed=323)
    records = [FastaRecord(f"scaf{i}", s)
               for i, s in enumerate(build_partial_assembly([g], gaps))]
    contigs, structure = split_scaffolds(records)
    reads, _ = simulate_reads([g], coverage=20.0, mean_length=25000,
                              sd_length=12500, error=0.13, seed=324)
    store = SeqStore(np.concatenate(reads), np.array([len(r) for r in reads]),
                     [f"read{i + 1}" for i in range(len(reads))])
    return Example(g, records, contigs, structure, reads, store)
