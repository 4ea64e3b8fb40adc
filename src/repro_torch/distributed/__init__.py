"""Distribution substrate (the counterpart of ``repro/distributed``): the
sharding policy and the straggler-resilient collectives on
``torch.distributed``."""
from repro_torch.distributed.collectives import (compressed_resilient_psum,
                                                 masked_allgather_mean,
                                                 resilient_psum)
from repro_torch.distributed.sharding import (activation_constraint,
                                              batch_axes, batch_shardings,
                                              cache_shardings,
                                              opt_state_shardings,
                                              param_shardings, resolve_pspec)

__all__ = ["resilient_psum", "masked_allgather_mean",
           "compressed_resilient_psum", "activation_constraint",
           "batch_axes", "batch_shardings", "cache_shardings",
           "opt_state_shardings", "param_shardings", "resolve_pspec"]
