"""Worker process for the multi-host test (see test_multihost.py).

Joins a 2-process ``jax.distributed`` CPU cluster through the
framework's own ``init_distributed`` (the multi-host entry point,
``parallel/dp.py``), builds the global 8-device mesh, runs the
PRODUCTION mapper and consensus sharded over it, and asserts both equal
this process's own single-device results — the multi-host analogue of
the reference's cluster execution (SURVEY §2.4 cluster-scheduling row),
where Snakemake jobs on different nodes merge through the filesystem.
"""

import os
import sys


def main() -> None:
    pid = sys.argv[1]
    port = sys.argv[2]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)

    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["DENTIST_TPU_COORDINATOR"] = f"localhost:{port}"
    os.environ["DENTIST_TPU_NUM_PROCESSES"] = "2"
    os.environ["DENTIST_TPU_PROCESS_ID"] = pid

    import jax

    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from dentist_tpu.parallel.dp import init_distributed, make_mesh

    assert init_distributed(), "init_distributed did not engage"
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 8, jax.devices()
    assert len(jax.local_devices()) == 4

    import __graft_entry__ as g
    from dentist_tpu.ops.mapper import MapperConfig, map_reads

    contigs, reads = g._simulated_scenario(seed=33)
    mesh = make_mesh()
    assert mesh.size == 8

    las_s, chains_s = map_reads(contigs.codes, contigs.offsets,
                                contigs.lengths, reads,
                                config=MapperConfig(), mesh=mesh)
    las_1, chains_1 = map_reads(contigs.codes, contigs.offsets,
                                contigs.lengths, reads,
                                config=MapperConfig(), mesh=None)
    assert len(las_s) > 0
    for f in ("a_id", "b_id", "complement", "a_begin", "a_end", "b_begin",
              "b_end", "diffs", "trace_offsets", "trace_diffs",
              "trace_b_adv", "chain_id"):
        assert np.array_equal(getattr(las_s, f), getattr(las_1, f)), f
    assert len(chains_s) == len(chains_1)

    # consensus sharded over the multi-host mesh == single-device
    from dentist_tpu.ops.consensus import consensus_batch
    from dentist_tpu.sim.genome import random_genome
    from dentist_tpu.sim.reads import _mutate

    rng = np.random.default_rng(91)
    truth = random_genome(700, seed=90)
    sets = [[_mutate(truth, rng, 0.13) for _ in range(8)] for _ in range(2)]
    cons_s = consensus_batch(sets, mesh=mesh)
    cons_1 = consensus_batch(sets)
    for a, b in zip(cons_s, cons_1):
        assert np.array_equal(a.sequence, b.sequence)
        assert np.array_equal(a.read_diffs, b.read_diffs)

    print(f"MULTIHOST_OK pid={pid} procs={jax.process_count()} "
          f"devices={len(jax.devices())}", flush=True)


if __name__ == "__main__":
    main()
