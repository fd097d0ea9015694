"""Training of the scene-graph VAE (counterpart of sln_tpu/train and the
root train.py): `python -m sln_tpu_torch.train`.

    losses.py      masked L1 / angle NLL / KL with free bits (global
                   normalizers under a mesh)
    loop.py        create_state, make_train_step (NaN skip, microbatching,
                   data parallelism under a mesh), the epoch index stream,
                   each rank's rows of it and the staged dataset
    checkpoint.py  the latest / snapshot / _no_model trio in the JAX
                   package's schema, and a loader for JAX-written files
    metrics.py     the JSONL metrics stream
    cli.py         the command line (`main`; N ranks under
                   torch.distributed.run with --num_data_shards N)
"""
