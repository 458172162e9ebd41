"""The distributed layer of the PyTorch port (``torch.distributed``).

Counterpart of ``repro.distributed``: ``sharding`` (the 2-D FSDP × TP
PartitionSpec rules), ``sharded_operators`` (``ShardedOperator``,
``SolveSharding`` and the ``sharded_*`` solvers behind the registry) and
``pipeline`` (a GPipe schedule over a ``stage`` axis); ``spec`` holds the
port's ``PartitionSpec`` (``P``) and the shape-only ``AbstractMesh``.
Meshes are ``DeviceMesh``es (``repro_torch.launch.mesh``).
"""
from repro_torch.distributed.sharded_operators import (ShardedOperator,
                                                       SolveSharding,
                                                       psum_reduction)
from repro_torch.distributed.sharding import (ShardingRules, batch_spec,
                                              decode_state_specs,
                                              kv_cache_spec, named,
                                              params_specs)
from repro_torch.distributed.spec import AbstractMesh, P, PartitionSpec
