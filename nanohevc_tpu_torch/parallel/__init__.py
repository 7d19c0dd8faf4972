"""Multi-device encoding: the device mesh and the frame- and
space-sharded batch encoders (see `parallel.mesh` for the execution
model)."""

from nanohevc_tpu_torch.parallel.mesh import make_mesh
from nanohevc_tpu_torch.parallel.sharding import (
    encode_batch_sharded,
    make_batch_encoder,
    make_closed_loop_encoder,
)

__all__ = [
    "make_mesh",
    "encode_batch_sharded",
    "make_batch_encoder",
    "make_closed_loop_encoder",
]
