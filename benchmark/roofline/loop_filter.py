"""Work count of the loop filters (`kernels/loop_filter.py`,
`csrc/deblock.cu`, `csrc/sao.cu`): deblocking, the CTB SAO estimate and
its application, one launch each a plane, on the three padded planes of
one frame call.

Frozen from `chip_smoke.py::filter_bound` and its constants: int32
samples read and written once each (8 bytes a sample a kernel; the
estimate also writes `STAT_INTS` + 6 ints a tile, the application reads
6 ints of parameters a tile); integer operations a sample `FILTER_OPS`
(deblocking's decisions and filters over an edge's samples, the
estimate's four classifications and band, the application's one), and
`DECIDE_OPS` float32 operations a tile for the estimate's decision,
all at the float32 rate.
"""

from benchlib import peaks

FILTER_OPS = {"deblock_planes": 18, "sao_estimate": 45, "sao_apply": 12}
DECIDE_OPS = 600
STAT_INTS = 96


def kernel_work(name: str, pixels: int, tiles: int) -> tuple:
    """(operations, bytes) of one filter kernel on one plane."""
    nbytes = pixels * 8
    ops = pixels * FILTER_OPS[name]
    if name == "sao_estimate":
        nbytes += tiles * 4 * (STAT_INTS + 6)
        ops += tiles * DECIDE_OPS
    if name == "sao_apply":
        nbytes += tiles * 4 * 6
    return ops, nbytes


def least_seconds(config: dict, work: dict) -> tuple:
    """(seconds, "bytes" or "operations") of one frame call's filter
    launches, each bounded by the larger of its two times, summed."""
    enc = config["encoder"]
    h, w, n = int(work["height"]), int(work["width"]), int(enc["block_size"])
    tile = int(enc["sao_tile"])
    total, by = 0.0, {}
    for pn, ph, pw in [(n, h, w)] + [(max(4, n // 2), h // 2, w // 2)] * 2:
        hp, wp = -(-ph // pn) * pn, -(-pw // pn) * pn
        tiles = -(-hp // tile) * -(-wp // tile)
        for name in FILTER_OPS:
            t, what = peaks.least_seconds(*kernel_work(name, hp * wp, tiles))
            total += t
            by[what] = by.get(what, 0.0) + t
    return total, max(by, key=by.get)
