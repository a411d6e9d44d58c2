"""Multi-GPU: process start-up (``distributed``), the (data x fsdp)
layout of the ranks (``mesh``) and ZeRO-3 over the fsdp ranks
(``fsdp``); counterpart of dsf_tpu/parallel/.  Of the
JAX package's re-exports, ``shard_batch`` and ``replicate`` place arrays
on a ``jax.sharding`` mesh and have no counterpart: each rank takes its
rows with ``mesh.Mesh.stripe``."""

from dsf_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
