"""Partition specs of the port (``partition``), the reference's
``repro.sharding``, with their DTensor placements."""
from repro_torch.sharding.partition import (PSpec, batch_pspec,
                                            cache_pspecs, distribute_params,
                                            params_pspecs, params_shardings,
                                            placements, tree_placements)

__all__ = ["PSpec", "batch_pspec", "cache_pspecs", "distribute_params",
           "params_pspecs", "params_shardings", "placements",
           "tree_placements"]
