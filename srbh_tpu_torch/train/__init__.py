"""The height model's training path: losses in ``losses/``, the state and
optimizer (``state``), the LR schedule (``schedule``), the steps
(``steps``), checkpoints (``checkpoint``), the CLI configuration
(``config``) and the trainer (``trainer``; ``python -m
srbh_tpu_torch.train``)."""
