"""Runtime layer of the PyTorch port: the implicit-diff solve service.

Counterpart of ``repro.runtime``, restricted to ``solve_service`` (the
continuous-batching front end that aggregates independent solve and
hypergradient requests into batched masked solves, with a warm-start
cache).  The training loop, LM serving and fault tolerance come with the
LM stack (ROADMAP queue A.12).
"""
from repro_torch.runtime.solve_service import (SolveService, ServiceResult,
                                               WarmStartCache, BucketKey,
                                               bucket_capacity)
