"""Two-process host-work sharding demo: the reference's --batch model.

The reference distributes the dominant (consensus) stage's HOST work by
slicing pile-ups across cluster jobs and merging the partial insertion
sets (``processPileUps --batch`` + ``mergeInsertions``,
``snakemake/Snakefile:1315-1358``).  The same surface exists here:

1. one process runs masks → mapping → collect and persists the stage
   containers (the staged-CLI artifacts),
2. TWO concurrent ``dentist-tpu process-pile-ups --batch a..b``
   subprocesses each consense half the pile-ups — the crop/vote/splice
   HOST passes split across processes, not just device lanes,
3. ``merge-insertions`` combines the halves,
4. the merged insertions must be byte-identical to a single-process run,
   and the wall-clock of step 2 is reported vs the single-process stage.

The demo pins the CPU backend: two JAX processes cannot share one GPU
(the first reserves most of its memory), and on a multi-GPU host each
process would own its cards via ``jax.distributed``.

Prints one JSON line: single-process stage seconds, 2-process stage
seconds, speedup, and the identity check.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402


def main():
    import tempfile

    from dentist_tpu.io.fasta import FastaRecord, codes_to_seq, write_fasta
    from dentist_tpu.sim.genome import insert_repeats, random_genome
    from dentist_tpu.sim.partial import build_partial_assembly, random_gaps
    from dentist_tpu.sim.reads import simulate_reads

    mb = 2
    for a in sys.argv[1:]:
        if a.startswith("--mb="):
            mb = int(a.split("=")[1])
    wd = tempfile.mkdtemp(prefix="dtpu-2proc-")
    g = random_genome(mb * 1_000_000, seed=90)
    g = insert_repeats(g, n_copies=4 * mb, repeat_length=3000, seed=91)
    truth = [g]
    gaps = random_gaps(truth, n_gaps=4 * mb, min_size=100, max_size=600,
                       margin=30_000, seed=92)
    asm = build_partial_assembly(truth, gaps)
    write_fasta(os.path.join(wd, "asm.fasta"),
                [(f"scaf{i}", codes_to_seq(s)) for i, s in enumerate(asm)])
    reads, _ = simulate_reads(truth, coverage=20.0, mean_length=25_000,
                              sd_length=12_500, error=0.13, seed=93)
    write_fasta(os.path.join(wd, "reads.fasta"),
                [(f"read{i+1}", codes_to_seq(r)) for i, r in enumerate(reads)])

    env = dict(os.environ,
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))),
               JAX_PLATFORMS="cpu")

    def cli(*args):
        r = subprocess.run([sys.executable, "-m", "dentist_tpu", *args],
                           capture_output=True, text=True, env=env, cwd=wd)
        if r.returncode != 0:
            print(r.stderr[-3000:], file=sys.stderr)
            raise SystemExit(1)
        return r.stdout

    # front half in-process (the shared artifacts the cluster jobs
    # would read from the filesystem): map -> repeat mask -> collect,
    # persisted in the staged-CLI container formats
    from dentist_tpu.io.store import (load_insertions, load_pile_ups,
                                      save_alignments, save_mask,
                                      save_pile_ups)
    from dentist_tpu.models.mask import coverage_mask, pack_chain_intervals
    from dentist_tpu.models.pileups import (ChainCtx, CollectConfig,
                                            collect_pile_ups)
    from dentist_tpu.models.sequences import SeqStore, load_assembly

    contigs, structure = load_assembly(os.path.join(wd, "asm.fasta"))
    store = SeqStore(np.concatenate(reads),
                     np.array([len(r) for r in reads]),
                     [f"read{i+1}" for i in range(len(reads))])
    from dentist_tpu.ops.mapper import MapperConfig, map_reads

    las, chains = map_reads(contigs.codes, contigs.offsets, contigs.lengths,
                            reads, config=MapperConfig(),
                            query_store=(store.codes, store.offsets))
    rep = coverage_mask(pack_chain_intervals(las), contigs.lengths, 0, 60)
    pile_ups = collect_pile_ups(ChainCtx(las, chains, contigs.lengths,
                                         store.lengths),
                                structure.gaps, rep, CollectConfig(),
                                contigs=contigs, reads=store)
    save_alignments(os.path.join(wd, "reads.las.npz"), las, chains)
    save_mask(os.path.join(wd, "rep.mask.npz"), rep)
    save_pile_ups(os.path.join(wd, "pile-ups.npz"), pile_ups)
    n_pu = len(pile_ups)

    def run_process(tag, batch=None):
        args = ["process-pile-ups", "asm.fasta", "reads.fasta",
                "reads.las.npz", "pile-ups.npz", f"ins-{tag}.npz",
                "--mask", "rep.mask.npz"]
        if batch:
            args += ["--batch", batch]
        return subprocess.Popen(
            [sys.executable, "-m", "dentist_tpu", *args],
            env=env, cwd=wd, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)

    # single process baseline
    t0 = time.time()
    p = run_process("single")
    assert p.wait() == 0
    single_s = time.time() - t0

    # two concurrent host processes, reference --batch model
    half = n_pu // 2
    t0 = time.time()
    pa = run_process("a", batch=f"0..{half}")
    pb = run_process("b", batch=f"{half}..{n_pu}")
    assert pa.wait() == 0 and pb.wait() == 0
    two_s = time.time() - t0
    cli("merge-insertions", "ins-merged.npz", "ins-a.npz", "ins-b.npz")

    a = load_insertions(os.path.join(wd, "ins-merged.npz"))
    b = load_insertions(os.path.join(wd, "ins-single.npz"))
    identical = len(a) == len(b) and all(
        x.start_node == y.start_node and x.end_node == y.end_node
        and np.array_equal(x.sequence, y.sequence)
        and x.read_ids == y.read_ids
        for x, y in zip(a, b))
    print(json.dumps({
        "n_pile_ups": n_pu,
        "process_stage_seconds_1proc": round(single_s, 1),
        "process_stage_seconds_2proc": round(two_s, 1),
        "host_sharding_speedup": round(single_s / max(two_s, 1e-9), 2),
        "merged_equals_single": identical,
        "n_insertions": len(a),
    }))
    assert identical, "2-process merged insertions != single-process"


if __name__ == "__main__":
    main()
