# Distribution layer (port of repro.distributed): the sharding rules
# (DP/TP/EP/SP + pod axis), ZeRO-1 optimizer partitioning, parameters held
# as local shards over a torch.distributed mesh, the GPipe pipeline, int8
# gradient compression.
from .sharding import (MeshParams, MeshSharder, NamedSharding, P, Region,
                       ShardingRules, batch_shardings, cache_shardings,
                       opt_state_shardings, param_shardings, replicated)

__all__ = ["ShardingRules", "MeshSharder", "param_shardings",
           "opt_state_shardings", "cache_shardings", "batch_shardings",
           "replicated", "P", "NamedSharding", "Region", "MeshParams"]
