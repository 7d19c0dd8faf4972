# Frozen copy of nanohevc_tpu_torch/ops/scan.py for the benchmark's plain reference
# (only the import lines differ); later changes to the port do not reach it.
"""Coefficient scan packing for the host entropy stage (spec 6.5.3).

Port of `nanohevc_tpu/ops/scan.py`: a static permutation gather over
the flattened block tensor.  "mode" picks the spec 7.4.9.11 scan per
block at 4x4/8x8 (vertical for modes 6-14, horizontal for 22-30,
diagonal otherwise and at every larger size).
"""

from __future__ import annotations

import torch

from plainref.params import SCAN_ORDERS, encoder_tables

SCAN_DIAG, SCAN_HORIZONTAL, SCAN_VERTICAL = 0, 1, 2


def mode_scan_idx(modes: torch.Tensor, n: int) -> torch.Tensor:
    """(nb,) intra modes -> (nb,) int32 in {0 diag, 1 horizontal,
    2 vertical}; always diagonal above 8x8."""
    sel = torch.full(modes.shape, SCAN_DIAG, dtype=torch.int32,
                     device=modes.device)
    if n not in (4, 8):
        return sel
    sel = torch.where((modes >= 6) & (modes <= 14), SCAN_VERTICAL, sel)
    sel = torch.where((modes >= 22) & (modes <= 30), SCAN_HORIZONTAL, sel)
    return sel.to(torch.int32)


def _permuted(flat: torch.Tensor, n: int, kind: str, modes, inverse: bool):
    suffix = "_inverse" if inverse else ""
    tabs = encoder_tables(n, device=flat.device)
    if kind == "mode" and n in (4, 8):
        if modes is None:
            raise ValueError("scan kind 'mode' needs per-block modes")
        per_kind = {
            k: flat[:, tabs[f"scan_{k}{suffix}"].long()] for k in SCAN_ORDERS
        }
        sel = mode_scan_idx(modes, n)[:, None]
        out = per_kind["diag"]
        out = torch.where(sel == SCAN_HORIZONTAL, per_kind["horizontal"], out)
        return torch.where(sel == SCAN_VERTICAL, per_kind["vertical"], out)
    if kind == "mode":
        kind = "diag"
    return flat[:, tabs[f"scan_{kind}{suffix}"].long()]


def scan_pack(levels: torch.Tensor, kind: str = "diag",
              modes: torch.Tensor | None = None) -> torch.Tensor:
    """(nb, N, N) -> (nb, N*N) in scan order (position 0 = DC)."""
    nb, n, _ = levels.shape
    return _permuted(levels.reshape(nb, n * n), n, kind, modes, False)


def scan_unpack(packed: torch.Tensor, kind: str = "diag",
                modes: torch.Tensor | None = None) -> torch.Tensor:
    """(nb, N*N) scan-ordered -> (nb, N, N) raster blocks."""
    nb, sq = packed.shape
    n = int(round(sq ** 0.5))
    return _permuted(packed, n, kind, modes, True).reshape(nb, n, n)
