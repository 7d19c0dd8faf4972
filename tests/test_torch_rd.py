"""The port's open-loop RD stages vs the JAX package's.

Seeded textured planes go through `nanohevc_tpu.models.all_intra`
(jitted, its XLA path) and `nanohevc_tpu_torch.models.all_intra` (on
the CPU; its mode decision is `ops.mode_decision`) with RDOQ, RD cbf
(both rate modes) and `decision="rd"` (DC/planar and all 35 modes, with
the MPM mode-rate term of the plane's grid), at N 4 (DST) to 32, 8 and
10 bits, QP 12/22/37 and on a plane that is not block-aligned.  Recon,
levels, modes and nnz must be equal.

Near-tie rule.  The adaptive rate model's prices take their
transcendentals in float64 on the host, so its bits may differ from
JAX's float32 ones in the last place.  Where a mode or a coded-block
decision differs, the test recomputes the two competing costs from
JAX's own cost arrays and passes that block only if they lie within
1e-5 relative; every other block must be equal.  The seeds are fixed;
`FLIPS` collects the near-ties shown (none on these seeds).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from nanohevc_tpu import ops as jops
from nanohevc_tpu.config import EncoderConfig
from nanohevc_tpu.frame import Frame, Plane
from nanohevc_tpu.models import all_intra as jax_ai
from nanohevc_tpu.ops.mode_rate import mode_bits_for_grid as j_mode_bits
from nanohevc_tpu.ops.rate import model_bits_adaptive as j_adaptive
from nanohevc_tpu.runtime import assemble_bitstream
from nanohevc_tpu_torch import config as port_config
from nanohevc_tpu_torch import frame as port_frame_mod
from nanohevc_tpu_torch.cli import assemble_frame_bitstream
from nanohevc_tpu_torch.models import all_intra as torch_ai
from nanohevc_tpu_torch.ops import mode_decision as torch_md

FLIPS = []
KINDS = {
    "rdoq": dict(rdoq=True),
    "cbf": dict(rdo_cbf=True),
    "cbf_heuristic": dict(rdo_cbf=True, rate_mode="heuristic"),
    "rd": dict(decision="rd"),
    "rd_all": dict(decision="rd", mode_set="all"),
    "rd_all_rdoq_cbf": dict(decision="rd", mode_set="all", rdoq=True,
                            rdo_cbf=True),
}
# (N, QP, bit depth)
GRID = [(4, 22, 8), (8, 22, 8), (16, 22, 8), (32, 22, 8), (8, 12, 8),
        (8, 37, 10)]


def textured(h, w, seed, bit_depth=8):
    """Seeded plane with ramps, waves, flat patches, edges and noise, so
    that every mode family wins somewhere and levels are nonzero."""
    rng = np.random.default_rng(seed)
    peak = (1 << bit_depth) - 1
    yy, xx = np.mgrid[0:h, 0:w]
    base = (yy * (peak + 1) // max(h, 1) + xx * (peak + 1) // (2 * w)
            + (peak // 6) * np.sin(xx / 5.0 + yy / 9.0))
    flat = rng.integers(0, 4, (h // 16 + 1, w // 16 + 1)) == 0
    base = np.where(flat[yy // 16, xx // 16], peak // 2, base)
    noise = rng.integers(-peak // 20, peak // 20 + 1, (h, w))
    return np.clip(base + noise, 0, peak).astype(np.int32)


def _plane_kw(n, bit_depth, kind, **extra):
    return dict(n=n, use_dst=n == 4, bit_depth=bit_depth, **KINDS[kind],
                **extra)


def jax_plane(plane, qp, kw):
    return {k: np.asarray(v) for k, v in jax.jit(
        lambda p, q: jax_ai.encode_plane_full(p, q, **kw))(
            jnp.asarray(plane), jnp.int32(qp)).items()}


def _jax_mode_costs(plane, qp, kw):
    """JAX's (nb, 35) RD costs of a plane, mode rate included, indexed by
    mode (DC/planar only: the other entries are inf)."""
    n, bd = kw["n"], kw["bit_depth"]
    h, w = plane.shape
    src = jnp.asarray(plane)
    blocks = jops.tile_plane(src, n)
    refs = jops.extract_refs(src, n, boundary=1 << (bd - 1))
    dc, pl = jops.dc_predict(refs, n), jops.planar_predict(refs, n)
    args = (n, qp, kw["use_dst"], bd, kw.get("dequant_rescale", False),
            kw.get("rd_lambda_scale", 1.0))
    both = np.asarray(jax_ai._rd_costs(blocks, jnp.stack([dc, pl], 1), *args))
    costs = np.full((both.shape[0], 35), np.inf, np.float32)
    costs[:, 0], costs[:, 1] = both[:, 1], both[:, 0]
    if kw.get("mode_set") == "all":
        preds = jops.angular_predict_all(refs, n)
        costs[:, 2:] = np.asarray(jax_ai._rd_costs(blocks, preds, *args))
        first = costs.argmin(axis=1)
    else:
        first = np.where(both[:, 0] <= both[:, 1], 1, 0)
    lam = np.float32(jax_ai._rd_lambda(qp, kw.get("rd_lambda_scale", 1.0)))
    bits = np.asarray(j_mode_bits(jnp.asarray(first.reshape(h // n, w // n),
                                              jnp.int32)))
    return costs + lam * bits


def _near(a, b):
    return abs(float(a) - float(b)) <= 1e-5 * abs(float(a))


def assert_plane_matches(plane, qp, kw, want, got):
    """Equal outputs, or differences only at near-ties (module doc)."""
    got = {k: v.numpy() for k, v in got.items()}
    n = kw["n"]
    for k in ("levels", "modes", "nnz"):
        assert got[k].dtype == want[k].dtype, k
    flip = np.zeros(want["modes"].shape, bool)
    mode_flip = want["modes"] != got["modes"]
    if mode_flip.any():
        costs = _jax_mode_costs(plane, qp, kw)
        for i in np.nonzero(mode_flip)[0]:
            assert _near(costs[i, want["modes"][i]], costs[i, got["modes"][i]]), i
        flip |= mode_flip
    cbf_flip = ~mode_flip & ((want["nnz"] == 0) != (got["nnz"] == 0))
    if cbf_flip.any():
        # skip iff d_skip <= d_coded + lambda * bits, from JAX's values;
        # the side that skipped holds the clipped prediction as recon
        assert kw.get("rdo_cbf")
        coded = jax_plane(plane, qp, dict(kw, rdo_cbf=False))
        tile = lambda x: np.asarray(jops.tile_plane(jnp.asarray(x), n))
        blocks = tile(plane).astype(np.int64)
        d_coded = ((blocks - tile(coded["recon"])) ** 2).sum(axis=(1, 2))
        if kw.get("rate_mode", "coder") == "coder":
            bits = np.asarray(j_adaptive(jnp.asarray(coded["levels"])))
        else:
            bits = np.asarray(jops.estimate_bits_blocks(jops.scan_unpack(
                jnp.asarray(coded["levels"]), kw.get("scan", "diag"),
                modes=jnp.asarray(coded["modes"]))))
        lam = np.float32(jax_ai._rd_lambda(qp, kw.get("rd_lambda_scale", 1.0)))
        for i in np.nonzero(cbf_flip)[0]:
            skipped = got if got["nnz"][i] == 0 else want
            d_skip = ((blocks[i] - tile(skipped["recon"])[i]) ** 2).sum()
            assert _near(d_skip, np.float32(d_coded[i]) + lam * bits[i]), i
        flip |= cbf_flip
    if flip.any():
        FLIPS.append((kw, qp, int(flip.sum())))
    keep = ~flip
    assert np.array_equal(got["levels"][keep], want["levels"][keep])
    assert np.array_equal(got["modes"][keep], want["modes"][keep])
    assert np.array_equal(got["nnz"][keep], want["nnz"][keep])
    h, w = plane.shape
    mask = np.repeat(np.repeat(keep.reshape(h // n, w // n), n, 0), n, 1)
    full = np.ones((h, w), bool)
    full[:mask.shape[0], :mask.shape[1]] = mask
    assert np.array_equal(got["recon"][full], want["recon"][full])


def _run_plane(h, w, seed, qp, kw):
    plane = textured(h, w, seed, kw["bit_depth"])
    want = jax_plane(plane, qp, kw)
    got = torch_ai.encode_plane_full(torch.from_numpy(plane), qp, **kw)
    assert_plane_matches(plane, qp, kw, want, got)
    return want, got


@pytest.mark.parametrize("n,qp,bit_depth", GRID)
@pytest.mark.parametrize("kind", list(KINDS))
def test_encode_plane_full_rd_matches_jax(kind, n, qp, bit_depth):
    h, w = (32, 48) if n < 32 else (64, 96)
    _run_plane(h, w, 100 * n + qp, qp, _plane_kw(n, bit_depth, kind))


@pytest.mark.parametrize("kind,n", [("rd_all", 8), ("rd_all_rdoq_cbf", 16),
                                    ("rd", 8), ("cbf", 4)])
def test_rd_on_a_plane_that_is_not_block_aligned(kind, n):
    """Partial edge blocks are dropped (the recon keeps the source
    there); the grid of the mode-rate term is the full blocks'."""
    _run_plane(37, 53, 7 + n, 27, _plane_kw(n, 8, kind))


@pytest.mark.parametrize("n", [8, 16])
def test_rd_all_with_smoothing_matches_jax(n):
    kw = _plane_kw(n, 8, "rd_all", intra_smoothing=True)
    plane = textured(32, 48, 40 + n)
    want = jax_plane(plane, 25, kw)
    got = torch_ai.encode_plane_full(torch.from_numpy(plane), 25, **kw)
    for k in ("recon", "levels", "modes", "nnz"):
        assert np.array_equal(got[k].numpy(), want[k]), k


@pytest.mark.parametrize("kind", ["rd_all_rdoq_cbf", "cbf_heuristic"])
def test_rd_scan_rescale_and_lambda_scale_match_jax(kind):
    kw = _plane_kw(8, 8, kind, scan="mode", dequant_rescale=True,
                   rd_lambda_scale=3.0)
    _run_plane(32, 48, 61, 22, kw)


def test_rd_changes_the_encode():
    """The RD stages act on these planes: RD cbf drops blocks at QP 12,
    RDOQ trims levels once lambda is scaled up, and the RD decision
    picks other modes than energy."""
    plane = torch.from_numpy(textured(64, 96, 99))
    nnz = {name: int(torch_ai.encode_plane_full(plane, qp, n=8, **kw)["nnz"]
                     .sum())
           for name, qp, kw in (
               ("base12", 12, {}), ("cbf12", 12, dict(rdo_cbf=True)),
               ("base22", 22, {}),
               ("rdoq22", 22, dict(rdoq=True, rd_lambda_scale=4.0)))}
    assert nnz["cbf12"] < nnz["base12"]
    assert nnz["rdoq22"] < nnz["base22"]
    base = torch_ai.encode_plane_full(plane, 22, n=8)
    rd = torch_ai.encode_plane_full(plane, 22, n=8, decision="rd")
    assert not torch.equal(rd["modes"], base["modes"])


def test_angular_chunks_price_the_whole_batch(monkeypatch):
    """The 35-mode RD search counts every chunk's bins before pricing:
    chunked, it decides exactly as in one chunk."""
    plane = torch.from_numpy(textured(32, 48, 5))
    kw = _plane_kw(8, 8, "rd_all")
    whole = torch_ai.encode_plane_full(plane, 22, **kw)
    monkeypatch.setattr(torch_md, "_SEARCH_CHUNK_ELEMS", 3 * 24 * 64)
    chunked = torch_ai.encode_plane_full(plane, 22, **kw)
    for k in whole:
        assert torch.equal(whole[k], chunked[k]), k


@pytest.mark.parametrize("mode_set", ["dc_planar", "all"])
def test_decide_modes_with_exact_mode_bits_matches_jax(mode_set):
    """The closed loop's form: mode bits given per block."""
    n = 8
    plane = textured(24, 40, 3)
    rng = np.random.default_rng(4)
    bits = np.where(rng.random((15, 35)) < 0.1, 2.0,
                    np.where(rng.random((15, 35)) < 0.2, 3.0, 6.0)
                    ).astype(np.float32)
    jb, jr = jops.tile_plane(jnp.asarray(plane), n), jops.extract_refs(
        jnp.asarray(plane), n)
    jp, jm = jax.jit(lambda b, r, q, mb: jax_ai.decide_modes(
        b, r, n, mode_set, "rd", qp=q, mode_bits=mb))(
            jb, jr, jnp.int32(30), jnp.asarray(bits))
    tp, tm = torch_md.decide_modes(
        torch.from_numpy(np.array(jb)), torch.from_numpy(np.array(jr)),
        n, mode_set, "rd", qp=30, mode_bits=torch.from_numpy(bits))
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    assert np.array_equal(tp.numpy(), np.asarray(jp))


# --- frames -------------------------------------------------------------------

FRAME_CONFIGS = {
    "rdo_rdoq": dict(rdo_cbf=True, rdoq=True),
    "rdo_rdoq_search": dict(rdo_cbf=True, rdoq=True, mode_set="all",
                            decision="satd"),
    "rd": dict(decision="rd"),
    "rd_all": dict(decision="rd", mode_set="all", rdoq=True),
}


def make_frame(h, w, seed):
    return Frame(Plane(textured(h, w, seed).astype(np.int16)),
                 Plane(textured(h // 2, w // 2, seed + 1).astype(np.int16)),
                 Plane(textured(h // 2, w // 2, seed + 2).astype(np.int16)))


@pytest.mark.parametrize("name", list(FRAME_CONFIGS))
def test_encode_frame_full_rd_matches_jax(name):
    """Recon, per-plane outputs, PSNR/SSIM and the bitstream bytes."""
    cfg = EncoderConfig(block_size=8, qp=22, **FRAME_CONFIGS[name])
    frame = make_frame(32, 64, 12)
    jr, ji = jax_ai.encode_frame_full(frame, cfg)
    pcfg = port_config.EncoderConfig(**cfg.__dict__)
    tr, ti = torch_ai.encode_frame_full(
        port_frame_mod.Frame(*(port_frame_mod.Plane(p.data)
                               for p in (frame.y, frame.u, frame.v))),
        pcfg, device="cpu")
    for p in "yuv":
        assert np.array_equal(getattr(tr, p).data, getattr(jr, p).data)
    for name_ in "YUV":
        for k in ("levels", "modes", "nnz", "block_size"):
            assert np.array_equal(ti["planes"][name_][k],
                                  ji["planes"][name_][k]), (name_, k)
    assert (ti["psnr_y"], ti["ssim_y"]) == (ji["psnr_y"], ji["ssim_y"])
    want = assemble_bitstream(
        64, 32, cfg.qp,
        {k: (p["levels"], p["block_size"]) for k, p in ji["planes"].items()},
        {k: p["modes"] for k, p in ji["planes"].items()})
    assert assemble_frame_bitstream(64, 32, pcfg, ti) == want


@pytest.mark.parametrize("cfg", [dict(rdo_cbf=True), dict(rdoq=True),
                                 dict(rdoq=True, mode_set="all",
                                      decision="satd")])
def test_rd_stages_route_to_the_plain_path(monkeypatch, cfg):
    """RD cbf and RDOQ never reach the slab or mode-search kernels, as
    in JAX (they are stages of the plain path only)."""
    calls = []
    for name in ("slab_encode_plane", "mode_search_encode_plane"):
        monkeypatch.setattr(torch_ai, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    frame = make_frame(16, 32, 1)
    torch_ai.encode_frame_full(
        port_frame_mod.Frame(*(port_frame_mod.Plane(p.data)
                               for p in (frame.y, frame.u, frame.v))),
        port_config.EncoderConfig(**cfg), device="cpu")
    assert calls == []
