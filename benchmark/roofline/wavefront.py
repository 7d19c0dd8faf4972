"""Work count of the wavefront kernel (`kernels/wavefront.py`,
`csrc/wavefront.cu`): the closed loop under a per-block decision of the
three planes of one frame call, whatever implements it.

Frozen from `chip_smoke.py::kernel_bound` (bytes: 12 a pixel, the
plane read and the recon and levels written, and 4 a block for its
mode; operations a pixel: the transform tail 8N + 18, then for the
35-mode search 35 modes of 2N + 10, prediction, residual, two N-term
Hadamard passes, |.| and sum, plus 9 for planar and DC; for DC/planar
by energy 16), extended by `roofline/wavefront_rd.py`'s rules to what
these inputs also need: the [1 2 1] smoothing of a luma block's 4N + 1
references (`SMOOTH_OPS` a reference sample, once a block; none at
4x4) and RDOQ on the chosen block (`RDOQ_OPS` a coefficient) where the
configuration sets it.  Integer operations are counted at the float32
rate.
"""

from benchlib import peaks

RDOQ_OPS = 24
SMOOTH_OPS = 4


def plane_work(n: int, height: int, width: int, mode_set: str, rdoq: bool,
               smoothing: bool) -> tuple:
    """(operations, bytes) of one plane, padded to blocks of n."""
    hp, wp = -(-height // n) * n, -(-width // n) * n
    pixels = hp * wp
    blocks = pixels // (n * n)
    search = 35 * (2 * n + 10) + 9 if mode_set == "all" else 16
    ops = (8 * n + 18 + search) * pixels
    if rdoq:
        ops += RDOQ_OPS * pixels
    if smoothing and n > 4:
        ops += SMOOTH_OPS * (4 * n + 1) * blocks
    return ops, 12 * pixels + 4 * blocks


def least_seconds(config: dict, work: dict) -> tuple:
    """(seconds, "bytes" or "operations") of one frame call: each
    plane's launch bounded by the larger of its two times, summed."""
    enc = config["encoder"]
    h, w, n = int(work["height"]), int(work["width"]), int(enc["block_size"])
    chroma_set = enc.get("chroma_mode_set") or enc["mode_set"]
    planes = [(n, h, w, enc["mode_set"], True)] + [
        (max(4, n // 2), h // 2, w // 2, chroma_set, False)] * 2
    total, by = 0.0, {}
    for pn, ph, pw, mode_set, luma in planes:
        t, what = peaks.least_seconds(*plane_work(
            pn, ph, pw, mode_set, bool(enc["rdoq"]),
            bool(enc["intra_smoothing"]) and luma))
        total += t
        by[what] = by.get(what, 0.0) + t
    return total, max(by, key=by.get)
