"""The device compute path: seeding, banded alignment, chaining, masking,
QV and consensus kernels.

Replaces the external Dazzler compute engines of the reference
(daligner, damapper, datander, DBdust, daccord, computeintrinsicqv — see
SURVEY.md §2.3) with in-process batched JAX computations.
"""
