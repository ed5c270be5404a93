"""Distribution layer: row-partitioned matrices over a jax.sharding.Mesh,
halo-exchange SpMV via shard_map collectives, psum-reduced dots
(SURVEY §2.7 — the communication backend the serial reference does not
have)."""

from lssp_tpu.parallel import multihost

__all__ = ["multihost"]
