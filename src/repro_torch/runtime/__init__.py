"""Runtime layer of the PyTorch port: training loop, fault tolerance and
the serving stack.

Counterpart of ``repro.runtime``: ``train_loop`` (the train step, its
state and the host loop with checkpoint, straggler and preemption hooks,
and the serve-step factories), ``fault_tolerance``, ``solve_service``
(the continuous-batching front end that aggregates independent solve and
hypergradient requests into batched masked solves, with a warm-start
cache) and ``serving`` (the continuous-batching LM engine).
"""
from repro_torch.runtime.solve_service import (SolveService, ServiceResult,
                                               WarmStartCache, BucketKey,
                                               bucket_capacity)
from repro_torch.runtime.serving import ContinuousBatchingEngine, Request
from repro_torch.runtime.train_loop import (TrainState, TrainStepConfig,
                                            make_train_state,
                                            make_train_step,
                                            make_prefill_step,
                                            make_decode_step)
from repro_torch.runtime.train_loop import train_loop as run_train_loop
from repro_torch.runtime.fault_tolerance import (StragglerMonitor,
                                                 HeartbeatRegistry,
                                                 PreemptionHandler,
                                                 ElasticPlan)
# keep the submodule accessible as repro_torch.runtime.train_loop
from repro_torch.runtime import train_loop as _tl_module
import sys as _sys
_sys.modules[__name__ + ".train_loop"] = _tl_module
