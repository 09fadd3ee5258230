"""The benchmark of ``paule_tpu_torch``, PAULE's PyTorch and CUDA port
(:mod:`portbench.run`).  Nothing here imports the JAX package or JAX."""
