"""The port's CTB SAO writer against the JAX package's.

`nanohevc_tpu_torch.runtime.bitstream.write_sao_ctb_params` codes the
tiles of a plane with array operations; the JAX package's
`write_sao_ctb_params` walks them one by one.  Each case holds the
port's payload to the original's byte for byte, and parses it back
with `parse_sao_ctb_params` to the parameters a decoder sees.  The
single-tile and two-tile cases are also held to bytes spelled out
here bit by bit.
"""

import itertools

import numpy as np
import pytest

import nanohevc_tpu.runtime.bitstream as j_bits
import nanohevc_tpu_torch.runtime.bitstream as t_bits
from nanohevc_tpu_torch.ref.sao import SAO_BO, SAO_EO0, SAO_OFF


def _off_w(bit_depth):
    return min(bit_depth, 10) - 4


def _maps(rng, nty, ntx, bit_depth=8, dtype=np.int64):
    """Seeded maps of one plane with runs of equal parameters, so that
    both merge flags are written."""
    half = 1 << (_off_w(bit_depth) - 1)
    tmap = rng.integers(0, 6, (nty, ntx))
    bmap = rng.integers(0, 32, (nty, ntx))
    omap = rng.integers(-half, half, (nty, ntx, 4))
    for ty, tx in itertools.product(range(nty), range(ntx)):
        r = rng.random()
        src = ((ty, tx - 1) if tx and r < 0.25 else
               (ty - 1, tx) if ty and r < 0.45 else None)
        if src:
            for m in (tmap, bmap, omap):
                m[ty, tx] = m[src]
    return tmap.astype(dtype), bmap.astype(dtype), omap.astype(dtype)


def _decoded(tmap, bmap, omap):
    """What a decoder reads back: the band of BO tiles only, the offsets
    of tiles that are not off."""
    tmap, bmap, omap = (np.asarray(m, np.int64) for m in (tmap, bmap, omap))
    on = tmap != SAO_OFF
    return (tmap, np.where(tmap == SAO_BO, bmap, 0),
            np.where(on[..., None], omap, 0))


def _check(sao_ctb, bit_depth=8):
    """The port's payload == the JAX package's, and it parses back."""
    got = t_bits.write_sao_ctb_params(sao_ctb, bit_depth)
    assert got == j_bits.write_sao_ctb_params(sao_ctb, bit_depth)
    parsed = t_bits.parse_sao_ctb_params(got)
    assert list(parsed) == list(sao_ctb)
    for name, (tile, *maps) in sao_ctb.items():
        ptile, *pmaps = parsed[name]
        assert ptile == tile
        for p, want in zip(pmaps, _decoded(*maps)):
            assert np.array_equal(p, want)
    return got


def _bits(fields):
    """Bytes of (value, width) fields written MSB-first, zero-padded."""
    s = "".join(format(v & ((1 << w) - 1), f"0{w}b") for v, w in fields)
    s += "0" * (-len(s) % 8)
    return bytes(int(s[i:i + 8], 2) for i in range(0, len(s), 8))


def _plane_payload(payload):
    """The tile syntax of a one-plane payload (after its 11-byte
    header)."""
    assert payload[:3] == b"NC\x01"
    return payload[3 + 11:]


def _tile_fields(t, band, offs, off_w):
    if t == SAO_OFF:
        return [(0, 2)]
    head = [(2, 2), (band, 5)] if t == SAO_BO else [(1, 2), (t - 1, 2)]
    return head + [(o, off_w) for o in offs]


@pytest.mark.parametrize("bit_depth", [8, 10])
@pytest.mark.parametrize("shape", [(17, 30), (9, 15)])
@pytest.mark.parametrize("seed", [0, 1, 2147483649])
def test_seeded_maps_with_both_merges(seed, shape, bit_depth):
    rng = np.random.default_rng(seed)
    tmap, bmap, omap = _maps(rng, *shape, bit_depth)
    par = np.concatenate([tmap[..., None], bmap[..., None], omap], -1)
    left, up = np.zeros(shape, bool), np.zeros(shape, bool)
    left[:, 1:] = (par[:, 1:] == par[:, :-1]).all(-1)
    up[1:] = (par[1:] == par[:-1]).all(-1)
    assert left.any() and (up & ~left).any() and not (left | up).all()
    _check({"Y": (64, tmap, bmap, omap)}, bit_depth)


@pytest.mark.parametrize("bit_depth", [8, 10])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_frame_of_the_cells(dtype, bit_depth):
    """A 1080p frame at tile 64: 17x30 luma tiles and 9x15 in each
    chroma plane, as the frame path hands them over (int32) and as
    int64."""
    rng = np.random.default_rng(23 + bit_depth)
    sao_ctb = {name: (64,) + _maps(rng, *shape, bit_depth, dtype)
               for name, shape in (("Y", (17, 30)), ("U", (9, 15)),
                                   ("V", (9, 15)))}
    _check(sao_ctb, bit_depth)


@pytest.mark.parametrize("t", [SAO_OFF, SAO_EO0, SAO_BO])
def test_uniform_map_merges_every_tile_after_the_first(t):
    nty, ntx = 9, 15
    tmap = np.full((nty, ntx), t)
    bmap = np.full((nty, ntx), 13)
    omap = np.broadcast_to(np.array([3, -2, 1, -4]), (nty, ntx, 4))
    payload = _plane_payload(_check({"U": (64, tmap, bmap, omap)}))
    first = _tile_fields(t, 13, [3, -2, 1, -4], 4)
    # The first row merges left, the first column up, the rest left.
    rest = [(1, 1)] * (nty * ntx - 1)
    assert payload == _bits(first + rest)


@pytest.mark.parametrize("bit_depth", [8, 10])
def test_checkerboard_codes_no_merge(bit_depth):
    nty, ntx = 6, 7
    yy, xx = np.mgrid[:nty, :ntx]
    tmap = np.where((yy + xx) % 2, SAO_BO, 2)
    bmap = np.full((nty, ntx), 31)
    omap = np.zeros((nty, ntx, 4), np.int64)
    payload = _plane_payload(_check({"Y": (32, tmap, bmap, omap)}, bit_depth))
    off_w = _off_w(bit_depth)
    fields = []
    for ty, tx in itertools.product(range(nty), range(ntx)):
        fields += [(0, 1)] * ((tx > 0) + (ty > 0))
        fields += _tile_fields(int(tmap[ty, tx]), 31, [0] * 4, off_w)
    assert payload == _bits(fields)


@pytest.mark.parametrize("bit_depth", [8, 10])
@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (7, 1)])
def test_thin_maps(shape, bit_depth):
    rng = np.random.default_rng(shape[0] * 10 + shape[1])
    _check({"V": (16,) + _maps(rng, *shape, bit_depth)}, bit_depth)


@pytest.mark.parametrize("t", range(6))
def test_every_type(t):
    offs = [1, -1, 7, -8]
    tmap, bmap = np.full((1, 1), t), np.full((1, 1), 31)
    omap = np.array(offs).reshape(1, 1, 4)
    payload = _plane_payload(_check({"Y": (64, tmap, bmap, omap)}))
    assert payload == _bits(_tile_fields(t, 31, offs, 4))


@pytest.mark.parametrize("band", [0, 31])
def test_band_ends(band):
    tmap = np.full((2, 2), SAO_BO)
    bmap = np.array([[band, 7], [7, band]])
    omap = np.arange(16).reshape(2, 2, 4) % 7
    _check({"Y": (64, tmap, bmap, omap)})


@pytest.mark.parametrize("bit_depth", [8, 10])
@pytest.mark.parametrize("end", ["low", "high"])
def test_offset_ends(end, bit_depth):
    half = 1 << (_off_w(bit_depth) - 1)
    o = -half if end == "low" else half - 1
    tmap = np.array([[SAO_BO, 1], [3, SAO_BO]])
    bmap = np.array([[5, 0], [0, 6]])
    omap = np.array([[[o, -o - 1, o, 0], [0, o, o, o]],
                     [[o, o, 0, o], [o, 0, -o - 1, o]]])
    _check({"U": (64, tmap, bmap, omap)}, bit_depth)


@pytest.mark.parametrize("field", ["band", "offset"])
@pytest.mark.parametrize("side", ["left", "up"])
def test_off_tiles_that_differ_in_stored_fields_do_not_merge(side, field):
    """Two OFF tiles merge only if every stored number is equal, as the
    original's tuple compare has it."""
    shape = (1, 2) if side == "left" else (2, 1)
    tmap = np.full(shape, SAO_OFF)
    bmap = np.zeros(shape, np.int64)
    omap = np.zeros(shape + (4,), np.int64)
    (bmap if field == "band" else omap)[-1, -1] = 9     # the second tile
    payload = _plane_payload(_check({"Y": (64, tmap, bmap, omap)}))
    # Type, then merge_left (or merge_up) 0, then type.
    assert payload == _bits([(0, 2), (0, 1), (0, 2)])


@pytest.mark.parametrize("tile", [8, 16, 64, 256])
def test_tile_sizes(tile):
    rng = np.random.default_rng(tile)
    payload = _check({"Y": (tile,) + _maps(rng, 4, 5)})
    assert payload[4] == tile.bit_length() - 1


def test_planes_in_the_dicts_order():
    rng = np.random.default_rng(5)
    sao_ctb = {name: (64,) + _maps(rng, 3, 4) for name in ("V", "Y", "U")}
    payload = _check(sao_ctb)
    assert payload[3] == 2                     # the first plane is V


@pytest.mark.parametrize("tile", [4, 12, 48, 512])
def test_bad_tile_raises(tile):
    rng = np.random.default_rng(0)
    sao_ctb = {"Y": (tile,) + _maps(rng, 2, 3)}
    for writer in (t_bits.write_sao_ctb_params, j_bits.write_sao_ctb_params):
        with pytest.raises(ValueError, match="power of two"):
            writer(sao_ctb)
