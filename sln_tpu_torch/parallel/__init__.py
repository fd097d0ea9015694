"""Data and tensor parallelism over processes (counterpart of
sln_tpu/parallel): `mesh.py` holds the (slice, data, model) mesh
(make_mesh, make_multislice_mesh), its collectives and the counterparts of
shard_batch, replicate and global_from_host_shards; `sharding.py` the
Megatron partition rules of the MLPs (partition_specs, shard_params,
gather_params).
"""
