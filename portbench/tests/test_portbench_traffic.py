"""The traffic generator: determinism by seed, shares per block, the
checked requests."""

import numpy as np
import pytest

from portbench.traffic import Mix, scene

SPEC = {"sizes": [[64, 48], [80, 60], [96, 72], [112, 84]],
        "pool_per_size": 3,
        "content": {"mean": [64.0, 192.0], "chroma": 0.35, "noise_std": 12.0,
                    "octaves": [[64, 40.0], [16, 20.0], [4, 10.0]]},
        "check": {"one_per_size": True, "within": 12}}


def test_same_seed_same_requests():
    a, b = Mix(SPEC, 2 ** 31 + 12345), Mix(SPEC, 2 ** 31 + 12345)
    for i in range(40):
        assert a.size_of(i) == b.size_of(i)
        assert np.array_equal(a.image(i), b.image(i))
    assert a.check_indices() == b.check_indices()


def test_other_seed_other_order_and_content():
    a, b = Mix(SPEC, 1), Mix(SPEC, 2)
    assert [a.size_of(i) for i in range(40)] != [b.size_of(i)
                                                 for i in range(40)]
    s = a.sizes[0]
    assert not np.array_equal(a.pools[s][0], b.pools[s][0])


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 1, 2 ** 40 + 3])
def test_every_block_holds_every_size_once(seed):
    m = Mix(SPEC, seed)
    n = len(m.sizes)
    for blk in range(25):
        got = sorted(m.size_of(blk * n + j) for j in range(n))
        assert got == sorted(m.sizes)


def test_images_are_the_stated_size_and_type():
    m = Mix(SPEC, 3)
    for i in range(8):
        w, h = m.size_of(i)
        img = m.image(i)
        assert img.shape == (h, w, 3) and img.dtype == np.uint8


def test_checked_requests_one_of_each_size_within_the_bound():
    m = Mix(SPEC, 99)
    idx = m.check_indices()
    assert len(idx) == len(m.sizes)
    assert all(0 <= i < 12 for i in idx)
    assert sorted(m.size_of(i) for i in idx) == sorted(m.sizes)
    one = Mix(dict(SPEC, check={"requests": 2, "within": 5}), 99)
    assert len(set(one.check_indices())) == 2


def test_scenes_are_smooth_under_their_noise():
    """Without the noise, neighbouring pixels differ by a few levels (no
    hard edges); the noise adds its stated std."""
    c = dict(SPEC["content"])
    smooth = scene(np.random.default_rng(5), 96, 128,
                   dict(c, noise_std=0.0)).astype(int)
    assert np.abs(np.diff(smooth, axis=0)).max() <= 32
    assert np.abs(np.diff(smooth, axis=1)).max() <= 32
    noisy = scene(np.random.default_rng(5), 96, 128, c).astype(int)
    assert np.std(noisy - smooth) == pytest.approx(c["noise_std"], rel=0.15)
