"""Collective accounting (port of arnerf_tpu/parallel/accounting.py).

The JAX package traces a block and sums the logical bytes entering every
collective primitive. Here the collectives run eagerly, so each wrapper in
parallel/dp.py and parallel/tp.py counts its operand's bytes on its mesh
as it calls the collective, under the name of the JAX primitive it stands
for: `psum` (all-reduce, sum or mean), `all_gather`, `reduce_scatter`
(lax.psum_scatter's primitive) and `pmax` (all-reduce, max). The trainer
keeps what its last block counted.

Logical bytes are the operand's size; a ring all-reduce moves 2(n-1)/n of
them per rank and an all-gather or reduce-scatter (n-1)/n (the all-gather
counts its input shard, the reduce-scatter its full input, as in JAX).
"""


def count(mesh, primitive: str, tensor):
    """Add `tensor`'s bytes to `mesh.collective_bytes[primitive]`."""
    nbytes = tensor.numel() * tensor.element_size()
    mesh.collective_bytes[primitive] = \
        mesh.collective_bytes.get(primitive, 0) + nbytes


def block_collective_report(trainer) -> dict:
    """Per-block and per-step collective bytes of the trainer's last
    training block (keys as JAX's report: per_block, total_block_bytes,
    total_step_bytes)."""
    per_block = getattr(trainer, "block_collectives", None)
    if per_block is None:
        raise ValueError("no training block has run on a mesh yet")
    total = sum(per_block.values())
    return {
        "per_block": dict(per_block),
        "total_block_bytes": total,
        "total_step_bytes": total / max(1, trainer.tc.update_interval),
    }
