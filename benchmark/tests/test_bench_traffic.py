"""The content generator repeats for a seed and changes with it."""

import numpy as np
import pytest

from benchlib import traffic


@pytest.mark.parametrize("seed", [0, 12345, 2 ** 31 + 98765, 2 ** 40 + 3])
def test_frames_repeat_for_a_seed(seed):
    a = traffic.make_frames(seed, 4, 72, 136, 2)
    b = traffic.make_frames(seed, 4, 72, 136, 2)
    assert len(a) == 4
    for fa, fb in zip(a, b):
        assert [p.shape for p in fa] == [(72, 136), (36, 68), (36, 68)]
        for pa, pb in zip(fa, fb):
            assert pa.dtype == np.int16 and np.array_equal(pa, pb)
            assert pa.min() >= 0 and pa.max() <= 255


def test_seeds_and_frames_differ():
    a = traffic.make_frames(1, 3, 64, 128, 8)
    b = traffic.make_frames(2, 3, 64, 128, 8)
    assert not np.array_equal(a[0][0], b[0][0])
    assert not np.array_equal(a[0][0], a[1][0])


def test_noise_is_the_amplitude_asked():
    base = traffic.pattern(256, 256)
    flat = traffic.textured(base, 0, np.random.default_rng(3))
    noisy = traffic.textured(base, 5, np.random.default_rng(3))
    d = noisy.astype(int) - flat
    assert np.abs(d[(flat > 5) & (flat < 250)]).max() == 5


def flat_tiles(plane, ty, tx):
    tiles = plane.reshape(ty, 64, tx, 64).transpose(0, 2, 1, 3)
    return (tiles == 127).all(axis=(2, 3))


@pytest.mark.parametrize("h,w", [(256, 320), (1080, 1920), (540, 960)])
def test_one_flat_patch_a_group(h, w):
    """One patch of every 2x2 group of 64x64 patches is flat, whatever
    the seed, also in the groups cut by the plane's edge."""
    base = traffic.pattern(h, w)
    ty, tx = -(-h // 64), -(-w // 64)
    for seed in range(4):
        p = traffic.textured(base, 0, np.random.default_rng(seed))
        pad = np.full((ty * 64, tx * 64), -1, np.int16)
        pad[:h, :w] = p
        tiles = pad.reshape(ty, 64, tx, 64).transpose(0, 2, 1, 3)
        flat = ((tiles == 127) | (tiles == -1)).all(axis=(2, 3))
        for gy in range(0, ty, 2):
            for gx in range(0, tx, 2):
                assert int(flat[gy:gy + 2, gx:gx + 2].sum()) == 1


def test_each_frame_draws_its_own_patches():
    """Frames are independent draws, not rolls of one plane: unrolled,
    two frames of a seed put their flat patches in different places."""
    frames = traffic.make_frames(7, 4, 256, 512, 0)
    masks = []
    for i, (y, _, _) in enumerate(frames):
        y = np.roll(y, (-5 * i, -11 * i), axis=(0, 1))
        masks.append(flat_tiles(y, 4, 8))
    assert all(int(m.sum()) == 8 for m in masks)
    assert len({m.tobytes() for m in masks}) == len(masks)
