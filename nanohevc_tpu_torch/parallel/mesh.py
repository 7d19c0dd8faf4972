"""Device mesh of the all-intra encoder, port of
`nanohevc_tpu/parallel/mesh.py`.

The codec's parallel axes are those of the JAX package:
  frame - data parallelism over the frame batch (no communication);
  space - rows of each plane split into shards; each shard needs one
          halo row from the shard above (and, for the 35-mode search,
          the first block-row of the shard below).

Execution model: one process drives every device, as JAX's single
controller does; `torch.distributed` is not used.  A `Mesh` is a 2-D
array of `torch.device`s over ("frame", "space").  The sharded encoders
(`parallel.spatial`, `parallel.sharding`) move each shard's input to
its device with `.to(device, non_blocking=True)`, launch its work on
that device's current stream, move halo rows between devices the same
way, and gather the outputs, in frame order, onto the mesh's first
device (`mesh.devices.flat[0]`).  The dispatch does not synchronise
the host.

A mesh may name the same device more than once: the shards placed on
one device run one after another on its stream.  Such a mesh (eight
"cpu" entries in the tests, a 2 x 2 mesh on one card in chip_smoke.py)
shows that the sharded encoders give the mesh-less outputs bit for
bit; it does not show a speedup.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import numpy as np
import torch

from nanohevc_tpu_torch import resolve_device


def canonical_device(device: str | torch.device) -> torch.device:
    """`resolve_device`, with a CUDA device's index filled in."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def move(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`t` on `device`; without blocking the host where the copy lands
    on a card (a copy to the host must be complete when it returns)."""
    return t.to(device, non_blocking=device.type == "cuda")


def on_device(device: torch.device):
    """A context in which `device` is the current CUDA device (a no-op
    for the CPU), so that each shard's launches go to its own device's
    current stream and the caller's current device is restored after."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class Mesh:
    """A (frame, space) grid of devices.

    `devices` is an (F, S) numpy object array of `torch.device`,
    `axis_names` the names of its two axes, and `shape` a dict from axis
    name to size, as on `jax.sharding.Mesh`.
    """

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


def make_mesh(
    devices: Sequence[str | torch.device] | None = None,
    axis_names: tuple[str, str] = ("frame", "space"),
    space: int | None = None,
) -> Mesh:
    """Build a 2-D (frame, space) mesh over the given devices.

    `devices=None` takes every CUDA device (and raises where there is no
    card; the CPU is never put in its place).  `space` fixes the spatial
    axis length (must divide the device count); by default spatial
    sharding is 1 (pure frame-data parallelism).
    """
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [canonical_device(d) for d in devices]
    n = len(devices)
    sp = 1 if space is None else space
    if n % sp != 0:
        raise ValueError(f"space={sp} does not divide device count {n}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(n // sp, sp), axis_names)


def frame_shard_size(mesh: Mesh, frames: int) -> int:
    """Frames per shard of the "frame" axis; raises ValueError when the
    batch does not divide over it (JAX refuses such a sharding too)."""
    f_axis = mesh.shape["frame"]
    if frames % f_axis:
        raise ValueError(f"a batch of {frames} frames does not divide over "
                         f"the mesh 'frame' axis ({f_axis})")
    return frames // f_axis


def gather(values: list, device: torch.device):
    """Concatenate the frame shards' outputs (tensors, or tuples of
    tensors as the SAO parameters are) along frames on `device`."""
    if isinstance(values[0], tuple):
        return tuple(gather(list(v), device) for v in zip(*values))
    return torch.cat([move(v, device) for v in values])


def frame_sharded(step: Callable, mesh: Mesh) -> Callable:
    """fn(planes, qp) -> dict that splits `planes` over the "frame" axis,
    runs step(shard, qp, row) -> dict for each shard with `row` its mesh
    row of devices (row[0] current; step moves the shard where it runs),
    and gathers the outputs in frame order onto the mesh's first device."""
    first = mesh.devices.flat[0]

    def run(planes: torch.Tensor, qp: int) -> dict:
        per = frame_shard_size(mesh, planes.shape[0])
        outs = []
        for i, row in enumerate(mesh.devices):
            with on_device(row[0]):
                outs.append(step(planes[i * per:(i + 1) * per], qp, row))
        return {k: gather([o[k] for o in outs], first) for k in outs[0]}

    return run
