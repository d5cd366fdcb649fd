"""The scene, its pool and where the playback starts are made from the
seed alone, and every seed asks the same work."""

import json

import numpy as np

from portbench import harness, scene

TRAFFIC = json.loads((harness.HERE / "traffic" / "void-moving.json").read_text())


def _small(**kw):
    t = dict(TRAFFIC, pool_frames=6)
    t["scene"] = dict(t["scene"], blobs=dict(t["scene"]["blobs"], sigma_px=4.0))
    t.update(kw)
    return t


def _seeds_by_mirror():
    out = {}
    for seed in range(2 ** 31, 2 ** 31 + 64):
        out.setdefault(scene.mirrors(seed), seed)
    assert len(out) == 4
    return out


def test_same_seed_same_pool_and_mirrors_differ():
    by = _seeds_by_mirror()
    a = scene.pool(_small(), 40, 30, 1, by[(False, False)], "cpu")
    b = scene.pool(_small(), 40, 30, 1, by[(False, False)], "cpu")
    assert a.dtype == np.uint8 and a.flags.c_contiguous
    assert np.array_equal(a, b)
    lr = scene.pool(_small(), 40, 30, 1, by[(True, False)], "cpu")
    ud = scene.pool(_small(), 40, 30, 1, by[(False, True)], "cpu")
    f = a.reshape(12, 30, 40)
    assert np.array_equal(lr.reshape(12, 30, 40), f[:, :, ::-1])
    assert np.array_equal(ud.reshape(12, 30, 40), f[:, ::-1, :])
    assert not np.array_equal(a, lr)


def test_every_seed_gives_each_pixel_series_of_the_same_set():
    series = []
    for seed in _seeds_by_mirror().values():
        p = scene.pool(_small(), 40, 30, 3, seed, "cpu")
        series.append(np.unique(p.T.reshape(-1, 3, 12).transpose(0, 2, 1)
                                .reshape(40 * 30, -1), axis=0))
    for s in series[1:]:
        assert np.array_equal(s, series[0])


def test_the_seed_picks_a_whole_chunk_of_the_cycle_to_start_at():
    starts = {scene.start_frame(seed, 480, 8)
              for seed in range(2 ** 31, 2 ** 31 + 200)}
    assert all(s % 8 == 0 and 0 <= s < 480 for s in starts)
    assert len(starts) > 40
    assert scene.start_frame(9, 480, 8) == scene.start_frame(9, 480, 8)
    by = _seeds_by_mirror()
    for m, seed in by.items():  # the start leaves the mirror as it was
        assert scene.mirrors(seed) == m


def test_pingpong_plays_forward_then_back():
    seq = scene.pool(_small(), 40, 30, 3, 9, "cpu")
    assert seq.shape == (12, 40 * 30 * 3)
    assert np.array_equal(seq[:6], seq[6:][::-1])


def test_colour_channels_differ():
    seq = scene.pool(_small(), 40, 30, 3, 9, "cpu").reshape(12, 30, 40, 3)
    assert not np.array_equal(seq[..., 0], seq[..., 1])
