"""Instrumented phase-C run: per-stage wall + prof-section attribution.

Run with DENTIST_TPU_PROF=1 on the GPU to attribute stage wall-clock
between device dispatch, result fetch, and host passes.  Mirrors
bench.py phase C (28 Mb / 147 gaps / 20x reads).  ``--small`` runs the
3 Mb / 16-gap phase-A/B scenario instead.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("DENTIST_TPU_PROF", "1")

import numpy as np


def main():
    from dentist_tpu.utils.cache import enable_compile_cache
    from dentist_tpu.utils.prof import prof_report

    enable_compile_cache()
    from dentist_tpu.ops.consensus import warm_shapes

    warm_shapes()

    from dentist_tpu.io.fasta import FastaRecord
    from dentist_tpu.models.sequences import SeqStore, split_scaffolds
    from dentist_tpu.pipeline import PipelineConfig, close_gaps
    from dentist_tpu.sim.genome import insert_repeats, random_genome
    from dentist_tpu.sim.partial import build_partial_assembly, random_gaps
    from dentist_tpu.sim.reads import simulate_reads

    small = "--small" in sys.argv
    e2e_size = 3_000_000 if small else 28_000_000
    n_gaps = 16 if small else 147
    coverage = 20.0
    t0 = time.time()
    g = random_genome(e2e_size, seed=321)
    g = insert_repeats(g, n_copies=4 * (e2e_size // 1_000_000),
                       repeat_length=3000, seed=322)
    e_truth = [g]
    e_gaps = random_gaps(e_truth, n_gaps=n_gaps, min_size=100, max_size=1000,
                         margin=25_000, seed=323)
    e_asm = build_partial_assembly(e_truth, e_gaps)
    e_records = [FastaRecord(f"scaf{i}", s) for i, s in enumerate(e_asm)]
    e_contigs, e_structure = split_scaffolds(e_records)
    e_reads, _ = simulate_reads(e_truth, coverage=coverage, mean_length=25000,
                                sd_length=12500, error=0.13, seed=324)
    e_store = SeqStore(np.concatenate(e_reads),
                       np.array([len(r) for r in e_reads]),
                       [f"read{i+1}" for i in range(len(e_reads))])
    print(f"datagen {time.time()-t0:.0f}s: {len(e_reads)} reads", file=sys.stderr)
    prof_report()

    from dentist_tpu.utils.log import STAGE_SECONDS, reset_stage_seconds

    reset_stage_seconds()
    t0 = time.time()
    result = close_gaps(e_contigs, e_structure, e_store, e_reads,
                        PipelineConfig(read_coverage=coverage))
    dt = time.time() - t0
    print(f"pipeline: {dt:.1f}s, {result.n_closed_gaps} gaps closed",
          file=sys.stderr)
    print("stages:", {k.split(".")[-1]: round(v, 1)
                      for k, v in sorted(STAGE_SECONDS.items(),
                                         key=lambda kv: -kv[1])},
          file=sys.stderr)
    prof_report()


if __name__ == "__main__":
    main()
