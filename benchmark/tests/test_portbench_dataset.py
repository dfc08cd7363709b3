"""The data set: written from the reference pattern once, and the probe's
flipped byte put back, also after a run that died in between."""

from __future__ import annotations

import os

import numpy as np

from benchmark import dataset, reference


def _bytes(path):
    return np.fromfile(path, dtype=np.uint8)


def test_written_once_as_the_pattern(tmp_path):
    d = str(tmp_path / "ds")
    paths = dataset.ensure(d, 2, 100003, 77)
    for p in paths:
        assert np.array_equal(_bytes(p), reference.pattern(0, 100003, 77))
    stamp = os.stat(paths[0]).st_mtime_ns
    assert dataset.ensure(d, 2, 100003, 77) == paths
    assert os.stat(paths[0]).st_mtime_ns == stamp
    assert dataset.warm(paths) == 2 * 100003


def test_probe_flip_is_repaired_by_the_next_run(tmp_path):
    d = str(tmp_path / "ds")
    paths = dataset.ensure(d, 1, 4096, 5)
    dataset.flip_byte(d, paths[0], 1234)
    assert _bytes(paths[0])[1234] != reference.pattern(0, 4096, 5)[1234]
    dataset.ensure(d, 1, 4096, 5)  # as a run that follows a killed one
    assert np.array_equal(_bytes(paths[0]), reference.pattern(0, 4096, 5))


def test_cut_marker_is_dropped(tmp_path):
    d = str(tmp_path / "ds")
    paths = dataset.ensure(d, 1, 4096, 5)
    with open(os.path.join(d, "probe"), "w") as f:
        f.write('{"path": ')
    dataset.ensure(d, 1, 4096, 5)
    assert not os.path.exists(os.path.join(d, "probe"))
    assert np.array_equal(_bytes(paths[0]), reference.pattern(0, 4096, 5))
