"""Multi-frame batch encoders (the mesh-less part of the JAX package's
`parallel`; sharding over several cards is not ported yet)."""

from nanohevc_tpu_torch.parallel.sharding import (
    make_batch_encoder,
    make_closed_loop_encoder,
)

__all__ = ["make_batch_encoder", "make_closed_loop_encoder"]
