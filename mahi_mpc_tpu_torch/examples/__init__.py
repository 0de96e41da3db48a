"""Runnable counterparts of the JAX package's ``examples/`` scripts:
``python -m mahi_mpc_tpu_torch.examples.<name> --help``.  Each runs on the
CUDA card unless given ``--device cpu``."""
