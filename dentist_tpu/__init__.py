"""dentist_tpu — a genome assembly gap-closing framework on JAX.

A from-scratch re-design of the capabilities of DENTIST
(a-ludi/dentist: close assembly gaps using long reads, "with focus on
correctness") as a single in-process JAX pipeline.  Where the
reference orchestrates 38 external Dazzler C binaries via a 1,537-line
Snakemake DAG, this framework runs every stage — k-mer seeded local
alignment, repeat/tandem/low-complexity masking, pile-up collection,
intrinsic-QV + windowed consensus, and gap-closed assembly emission — as
batched device computations (XLA, run on an NVIDIA GPU) over 2-bit-packed,
device-resident sequence stores.

Layout (see SURVEY.md for the reference layer map this re-expresses):

- :mod:`dentist_tpu.utils`    — interval/Region algebra, math helpers,
  structured JSON logging (reference: ``source/dentist/util/``).
- :mod:`dentist_tpu.io`       — FASTA/BED/AGP parsing and emission, 2-bit
  packing, Dazzler ``.las``/mask-format import/export edges (reference:
  ``source/dentist/dazzler.d``, ``util/fasta.d``).
- :mod:`dentist_tpu.ops`      — the device compute path: seeding, banded
  trace-point alignment, chaining, masking and consensus kernels
  (replaces daligner/damapper/datander/DBdust/daccord).
- :mod:`dentist_tpu.models`   — the domain model and pipeline stages:
  alignment chains, scaffold graph, pile-ups, insertions, output
  (reference: ``source/dentist/common/`` + ``source/dentist/commands/``).
- :mod:`dentist_tpu.parallel` — device-mesh sharding and collectives
  (replaces the Snakemake/SLURM block-parallel job DAG).
- :mod:`dentist_tpu.sim`      — read/genome simulator and gapped-assembly
  builder (reference: Dazzler ``simulator`` + ``build-partial-assembly``).
- :mod:`dentist_tpu.eval`     — ground-truth evaluation
  (reference: ``check-results`` / ``find-closable-gaps``).
"""

__version__ = "0.1.0"
