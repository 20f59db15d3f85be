"""Runnable walkthroughs of the port: ``python -m
srbh_tpu_torch.examples.quickstart`` and ``python -m
srbh_tpu_torch.examples.parallel_modes``."""
