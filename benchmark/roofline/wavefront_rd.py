"""Work count of the RD kernel (`kernels/wavefront_rd.py`,
`csrc/wavefront_rd.cu`): the closed loop under decision="rd" of the
three planes of one frame call, whatever implements it.

Frozen from `chip_smoke.py::rd_bound` (bytes: 12 a pixel, the plane
read and the recon and levels written, and 4 a block for its mode;
operations a pixel: for each candidate mode the transform tail 8N + 18
plus 40 for prediction and residual, SSE, bin counts and bits, then
the chosen block's tail 8N + 18 again; the adaptive prices, 45 contexts
of 4 float64 transcendentals at about 20 operations, once a batch and
diagonal), extended by the same rule to what these inputs also need:
RDOQ on the chosen block (`RDOQ_OPS` a coefficient: three candidate
levels, each a distortion and a rate, and the last position's running
sums) and the [1 2 1] smoothing of a luma block's 4N + 1 references
(`SMOOTH_OPS` a reference sample, once a block; none at 4x4).
Integer operations are counted at the float32 rate.
"""

from benchlib import peaks

RDOQ_OPS = 24
SMOOTH_OPS = 4
PRICE_OPS = 45 * 4 * 20


def plane_work(n: int, height: int, width: int, mode_set: str, rdoq: bool,
               smoothing: bool) -> tuple:
    """(operations, bytes) of one plane, padded to blocks of n."""
    hp, wp = -(-height // n) * n, -(-width // n) * n
    pixels = hp * wp
    diagonals = hp // n + wp // n - 1
    cands, batches = (35, 2) if mode_set == "all" else (2, 1)
    ops = ((cands * (8 * n + 18 + 40) + 8 * n + 18) * pixels
           + batches * PRICE_OPS * diagonals)
    if rdoq:
        ops += RDOQ_OPS * pixels
    if smoothing and n > 4:
        ops += SMOOTH_OPS * (4 * n + 1) * (pixels // (n * n))
    return ops, 12 * pixels + 4 * pixels // (n * n)


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
