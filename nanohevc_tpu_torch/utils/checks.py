# Copy of nanohevc_tpu/utils/checks.py (only the import lines differ).
"""Opt-in numerical sanitizer: sampled device-vs-oracle parity checks.

The integer codec has no NaNs to detect; its failure mode is silent
bit drift (wrong rounding, overflow).  This is the project's analog of
a sanitizer (SURVEY §5): in dev/debug runs, re-derive a random sample
of blocks with the int64 numpy oracle and compare against the device
output bit-for-bit.
"""

from __future__ import annotations

import numpy as np

from nanohevc_tpu_torch import ref as oracle


def sample_parity_check(
    plane: np.ndarray,
    levels_raster: np.ndarray,
    recon: np.ndarray,
    n: int,
    qp: int,
    samples: int = 64,
    seed: int = 0,
) -> int:
    """Return the number of mismatching sampled blocks (0 == clean).

    Checks the open-loop dc_planar full pipeline (the flagship path).
    `levels_raster` is (nb, N, N) in raster coefficient order.
    """
    h, w = plane.shape
    nbx = w // n
    nb = (h // n) * nbx
    rng = np.random.default_rng(seed)
    sample = rng.choice(nb, size=min(samples, nb), replace=False)
    bad = 0
    for b in sample:
        y0, x0 = (b // nbx) * n, (b % nbx) * n
        blk = plane[y0 : y0 + n, x0 : x0 + n]
        top = (
            np.full(n, 128, np.int16)
            if y0 == 0
            else plane[y0 - 1, x0 : x0 + n].astype(np.int16)
        )
        left = (
            np.full(n, 128, np.int16)
            if x0 == 0
            else plane[y0 : y0 + n, x0 - 1].astype(np.int16)
        )
        dc = oracle.intra_dc_predict(top, left, n)
        pl = oracle.intra_planar_predict(top, left, int(top[-1]), int(left[-1]), n)
        e_dc = oracle.residual_energy(oracle.residual_block(blk.astype(np.int16), dc))
        e_pl = oracle.residual_energy(oracle.residual_block(blk.astype(np.int16), pl))
        pred = dc if e_dc <= e_pl else pl
        res = blk.astype(np.int32) - pred.astype(np.int32)
        lvl = oracle.quantize(oracle.forward_transform(res), qp, n)
        inv = oracle.inverse_transform(oracle.dequantize(lvl, qp, n))
        want_recon = np.clip(pred.astype(np.int32) + inv, 0, 255)
        got_recon = recon[y0 : y0 + n, x0 : x0 + n]
        if not (
            np.array_equal(lvl, levels_raster[b])
            and np.array_equal(want_recon, got_recon)
        ):
            bad += 1
    return bad
