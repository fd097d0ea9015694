"""Data parallelism over processes (counterpart of sln_tpu/parallel):
`mesh.py` holds the data-only mesh, its collectives and the counterparts
of shard_batch, replicate and global_from_host_shards. The JAX package's
tensor parallelism (`sharding.py`) and multi-slice mesh are not ported.
"""
