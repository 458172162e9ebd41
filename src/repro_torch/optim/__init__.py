"""Optimizers, schedules and gradient compression of the port
(counterpart of ``repro.optim``)."""
from repro_torch.optim.optimizer import (adamw, lion, sgd, apply_updates,
                                         clip_by_global_norm, global_norm,
                                         OptState, Optimizer, OPTIMIZERS)
from repro_torch.optim import schedules, grad_compression
