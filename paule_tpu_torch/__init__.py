"""PyTorch/CUDA port of paule_tpu (see README, "PyTorch/CUDA port")."""
