"""Placement of the LM template over a device mesh (``repro.sharding``):
the rules, the blocks of a tree at a mesh position, the mesh context and
its collectives."""
from repro_torch.sharding.comm import (Collectives, LiveCollectives,
                                       MetaCollectives, make_collectives)
from repro_torch.sharding.ctx import (MeshCtx, RankPlan, ShardedCaches,
                                      make_ctx)
from repro_torch.sharding.rules import (Spec, batch_specs, cache_specs,
                                        fsdp_axes, mesh_coords, param_specs,
                                        shard_tree, unshard_tree)

__all__ = ["Collectives", "LiveCollectives", "MeshCtx", "MetaCollectives",
           "RankPlan", "ShardedCaches", "Spec", "batch_specs", "cache_specs",
           "fsdp_axes", "make_collectives", "make_ctx",
           "mesh_coords", "param_specs", "shard_tree", "unshard_tree"]
