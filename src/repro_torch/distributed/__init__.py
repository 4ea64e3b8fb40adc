"""Straggler-resilient collectives on ``torch.distributed`` (the
counterpart of ``repro/distributed/collectives.py``).  The reference's
sharding rules and mesh wait for ROADMAP Queue 1 item 12."""
from repro_torch.distributed.collectives import (compressed_resilient_psum,
                                                 masked_allgather_mean,
                                                 resilient_psum)

__all__ = ["resilient_psum", "masked_allgather_mean",
           "compressed_resilient_psum"]
