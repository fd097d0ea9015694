"""Training of the scene-graph VAE (counterpart of sln_tpu/train and the
root train.py): `python -m sln_tpu_torch.train`.

    losses.py      masked L1 / angle NLL / KL with free bits
    loop.py        create_state, make_train_step (NaN skip, microbatching),
                   the epoch index stream and the staged dataset
    checkpoint.py  the latest / snapshot / _no_model trio in the JAX
                   package's schema, and a loader for JAX-written files
    metrics.py     the JSONL metrics stream
    cli.py         the command line (`main`)
"""
