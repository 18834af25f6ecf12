"""10 Mb end-to-end stress run (the PARITY.md scale scenario).

Builds a 10 Mb genome with 40 interspersed repeat copies, punches 8
gaps (→ 9 contigs), simulates ~20× 25 kb reads at 13 % error, runs the
full pipeline, and checks the result against the truth.  Prints one
JSON line with timings + gap stats.
"""

import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402


def main():
    from dentist_tpu.utils.cache import enable_compile_cache
    from dentist_tpu.utils.log import set_log_level

    enable_compile_cache()
    if "--timings" in sys.argv:
        set_log_level("diagnostic")

    from dentist_tpu.eval.check_results import check_results
    from dentist_tpu.io.fasta import FastaRecord
    from dentist_tpu.models.sequences import split_scaffolds
    from dentist_tpu.pipeline import STAGE_KEYS, PipelineConfig, close_gaps
    from dentist_tpu.sim.genome import insert_repeats, random_genome
    from dentist_tpu.sim.partial import build_partial_assembly, random_gaps
    from dentist_tpu.sim.reads import simulate_reads
    from dentist_tpu.models.sequences import SeqStore

    mb = 10
    for a in sys.argv[1:]:
        if a.startswith("--mb="):
            mb = int(a.split("=")[1])
    t0 = time.time()
    g = random_genome(mb * 1_000_000, seed=42)
    g = insert_repeats(g, n_copies=4 * mb, repeat_length=3000, seed=43)
    truth = [g]
    gaps = random_gaps(truth, n_gaps=mb, min_size=100, max_size=1000,
                       margin=50_000, seed=44)
    asm = build_partial_assembly(truth, gaps)
    records = [FastaRecord(f"scaf{i}", s) for i, s in enumerate(asm)]
    contigs, structure = split_scaffolds(records)
    reads, _ = simulate_reads(truth, coverage=20.0, mean_length=25_000,
                              sd_length=12_500, error=0.13, seed=45)
    reads_store = SeqStore(np.concatenate(reads),
                           np.array([len(r) for r in reads]),
                           [f"read{i+1}" for i in range(len(reads))])
    datagen_s = time.time() - t0
    print(f"datagen {datagen_s:.0f}s: {len(reads)} reads "
          f"({sum(len(r) for r in reads)/1e6:.0f} Mb)", file=sys.stderr,
          flush=True)

    from dentist_tpu.utils.log import STAGE_SECONDS, reset_stage_seconds

    reset_stage_seconds()
    t0 = time.time()
    result = close_gaps(contigs, structure, reads_store, reads,
                        PipelineConfig(read_coverage=20.0))
    pipeline_s = time.time() - t0
    print(f"pipeline {pipeline_s:.0f}s", file=sys.stderr, flush=True)
    # peak host memory envelope (the reference pins 1.7 GB on its
    # example, README "Local Execution"; cluster.yml budgets per rule)
    import resource

    peak_rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    stage_seconds = {name: round(STAGE_SECONDS.get(key, 0.0), 1)
                     for name, key in STAGE_KEYS.items()}

    from dentist_tpu.io.fasta import seq_to_codes

    res_codes = [seq_to_codes(seq) for _, seq in result.records]
    stats = check_results(truth, structure, contigs, res_codes)
    js = stats.to_json()
    print(json.dumps({
        "mb": mb,
        "pipeline_seconds": round(pipeline_s, 1),
        "stage_seconds": stage_seconds,
        "peak_rss_gb": round(peak_rss_gb, 2),
        "n_reads": len(reads),
        "numClosedGaps": js["numClosedGaps"],
        "numCorrectGaps": js["numCorrectGaps"],
        "perIdentity": js["numCorrectGapsPerIdentityLevel"],
        "averageInsertionError": js["averageInsertionError"],
    }))


if __name__ == "__main__":
    main()
