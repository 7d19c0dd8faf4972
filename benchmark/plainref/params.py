# Frozen copy of nanohevc_tpu_torch/params.py for the benchmark's plain reference
# (only the import lines differ); later changes to the port do not reach it.
"""The codec's fixed state: spec tables and per-QP scalars.

The codec has no learned weights.  What it carries across calls is
the spec tables of `tables` (the port's copy of `nanohevc_tpu.tables`)
and the `EncoderConfig`.  `encoder_tables` puts the same numpy arrays the JAX
package hands to its device into int32 tensors; `qp_scalars` is the
port of `nanohevc_tpu.kernels.slab_pipeline._qp_scalars`.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from plainref.tables import (
    DEQUANT_SCALE,
    QUANT_SCALE,
    diag_scan_order,
    horizontal_scan_order,
    transform_matrix,
    vertical_scan_order,
)

SCAN_ORDERS = {
    "diag": diag_scan_order,
    "horizontal": horizontal_scan_order,
    "vertical": vertical_scan_order,
}


class QpScalars(NamedTuple):
    """Per-(QP, N, bit depth) integers of the quant/dequant/clip tail.

    dq_shift is signed: 4 - qp_per keeps the reference's
    size-independent dequant (parity), 6 - log2N - qp_per restores the
    spec size rescale (negative means a left shift).
    """

    mf: int
    qshift: int
    qoffset: int
    dscale: int
    dq_shift: int
    max_pix: int
    boundary: int


def qp_scalars(qp: int, n: int, bit_depth: int = 8,
               dequant_rescale: bool = False) -> QpScalars:
    """Scalars for the intra deadzone quantizer at a static QP."""
    qp_c = max(0, min(51, int(qp)))
    qp_per, qp_rem = qp_c // 6, qp_c % 6
    log2n = n.bit_length() - 1
    qshift = 14 + qp_per + log2n
    dq_shift = (6 - log2n if dequant_rescale else 4) - qp_per
    return QpScalars(
        QUANT_SCALE[qp_rem], qshift, (1 << qshift) // 3,
        DEQUANT_SCALE[qp_rem], dq_shift, (1 << bit_depth) - 1,
        1 << (bit_depth - 1),
    )


def encoder_tables(n: int, use_dst: bool = False,
                   device: str | torch.device = "cpu") -> dict:
    """int32 tensors of the spec tables for block size n on `device`.

    Keys: "transform" (N, N), "quant_scale" (6,), "dequant_scale" (6,),
    and "scan_<kind>" / "scan_<kind>_inverse" (N*N,) for each scan kind.
    The tensors are cached per (n, use_dst, device): treat them as
    read-only.
    """
    return _encoder_tables(n, bool(use_dst), str(torch.device(device)))


@lru_cache(maxsize=None)
def _encoder_tables(n: int, use_dst: bool, device: str) -> dict:
    out = {
        # a copy: the numpy matrices are the shared spec tables
        "transform": torch.tensor(
            np.asarray(transform_matrix(n, use_dst), np.int32), device=device
        ),
        "quant_scale": torch.tensor(QUANT_SCALE, dtype=torch.int32,
                                    device=device),
        "dequant_scale": torch.tensor(DEQUANT_SCALE, dtype=torch.int32,
                                      device=device),
    }
    for kind in SCAN_ORDERS:
        order = SCAN_ORDERS[kind](n)     # packed[k] = flat[order[k]]
        out[f"scan_{kind}"] = torch.as_tensor(order, device=device)
        out[f"scan_{kind}_inverse"] = torch.as_tensor(
            np.argsort(order).astype(np.int32), device=device
        )
    return out
