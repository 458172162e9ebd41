"""Runtime layer of the PyTorch port: the implicit-diff solve service and
LM serving.

Counterpart of ``repro.runtime``: ``solve_service`` (the
continuous-batching front end that aggregates independent solve and
hypergradient requests into batched masked solves, with a warm-start
cache), ``serving`` (the continuous-batching LM engine) and the serve-step
factories of ``train_loop``.  Training and fault tolerance come with the
training slice (ROADMAP queue A.12).
"""
from repro_torch.runtime.solve_service import (SolveService, ServiceResult,
                                               WarmStartCache, BucketKey,
                                               bucket_capacity)
from repro_torch.runtime.serving import ContinuousBatchingEngine, Request
from repro_torch.runtime.train_loop import make_decode_step, make_prefill_step
