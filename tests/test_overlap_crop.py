"""Overlapping-contigs join: the consensus implies the flank contigs
overlap, and the pipeline must CROP the entering contig instead of
dropping the join (``processPileUps/package.d:621-769``,
``insertions.d:107-284``)."""

import numpy as np

from dentist_tpu.io.fasta import FastaRecord, codes_to_seq
from dentist_tpu.models.sequences import split_scaffolds, SeqStore
from dentist_tpu.pipeline import close_gaps, PipelineConfig
from dentist_tpu.sim.genome import random_genome
from dentist_tpu.sim.reads import simulate_reads


def test_overlapping_contigs_close_with_crop():
    truth = random_genome(24_000, seed=60)
    overlap = 200
    # scaffold: contig A = truth[:12300], gap of n's, contig B = truth[12000:]
    # — A and B share `overlap` bases of truth around position 12150
    a = truth[: 12_000 + overlap]
    b = truth[12_000 :]
    seq = codes_to_seq(a) + "n" * 50 + codes_to_seq(b)
    records = [FastaRecord("scaf0", np.frombuffer(seq.encode(), np.uint8))]
    # split_scaffolds expects code arrays; build via FastaRecord text path
    from dentist_tpu.io.fasta import seq_to_codes

    records = [FastaRecord("scaf0", seq_to_codes(seq))]
    contigs, structure = split_scaffolds(records)
    assert len(contigs) == 2 and len(structure.gaps) == 1

    read_list, _ = simulate_reads([truth], coverage=20, mean_length=8000,
                                  sd_length=2000, error=0.13, seed=61)
    reads = SeqStore(np.concatenate(read_list),
                     np.array([len(r) for r in read_list]),
                     [f"read{i+1}" for i in range(len(read_list))])

    result = close_gaps(contigs, structure, reads, read_list,
                        PipelineConfig(no_validation=True, read_coverage=20.0))
    assert result.n_closed_gaps == 1
    out = "".join(s for _, s in result.records).lower()
    assert out == codes_to_seq(truth).lower(), "cropped join must be byte-exact"
