"""Multi-device runs of the port over ``torch.distributed``: ``launch``
starts rank processes, ``mesh`` holds the JAX package's parallel/mesh.py
entry points, ``dryrun`` its multichip dry run."""
