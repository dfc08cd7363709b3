"""The port's chart tool (elbencho_tpu_torch/tools/chart.py) against the
original's (elbencho_tpu/tools/chart.py), case for case with
tests/test_tools.py: both read the same CSV and must list the same columns
and operations, refuse with the same words and exit codes, and write an
image of the same format. Every compared value is a string, an integer or
a file's leading bytes, compared exactly."""

import csv
import os
import sys

import pytest

from elbencho_tpu.tools import chart as jax_chart
from elbencho_tpu_torch.tools import chart as torch_chart

CHARTS = (jax_chart, torch_chart)
# the first bytes of each image format the tools write
MAGIC = {".svg": b"<?xml", ".png": b"\x89PNG", ".pdf": b"%PDF"}


@pytest.fixture
def csvfile(tmp_path):
    path = tmp_path / "results.csv"
    rows = [
        {"operation": "WRITE", "block size": "4096", "MiB/s last": "100",
         "IOPS last": "25600", "lat avg us": "11"},
        {"operation": "READ", "block size": "4096", "MiB/s last": "200",
         "IOPS last": "51200", "lat avg us": "7"},
        {"operation": "WRITE", "block size": "1048576", "MiB/s last": "2000",
         "IOPS last": "2000", "lat avg us": "470"},
        {"operation": "READ", "block size": "1048576", "MiB/s last": "3800",
         "IOPS last": "3800", "lat avg us": "250"},
    ]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return str(path)


def _both(capsys, argv, image=None):
    """(rc, stdout, stderr) of each tool on the same argv, the original's
    first; with `image`, each tool's image file is read after its run and
    its bytes end the tuple."""
    out = []
    for chart in CHARTS:
        rc = chart.main(list(argv))
        cap = capsys.readouterr()
        res = (rc, cap.out, cap.err)
        if image is not None:
            with open(image, "rb") as f:
                res += (f.read(),)
            os.remove(image)
        out.append(res)
    return out


def test_chart_list_columns(csvfile, capsys):
    j, t = _both(capsys, ["-c", csvfile])
    assert j == t
    assert t[0] == 0
    assert "operation" in t[1].splitlines()
    assert "MiB/s last" in t[1].splitlines()


def test_chart_list_operations(csvfile, capsys):
    j, t = _both(capsys, ["-o", csvfile])
    assert j == t
    assert t[0] == 0 and t[1].splitlines() == ["WRITE", "READ"]


@pytest.mark.parametrize("ext", [".svg", ".png", ".pdf"])
def test_chart_line_with_op_filters_and_y2(csvfile, tmp_path, capsys, ext):
    out = str(tmp_path / f"c{ext}")
    j, t = _both(capsys, [
        "-x", "block size", "-y", "MiB/s last:READ", "-y",
        "MiB/s last:WRITE", "-Y", "IOPS last:READ", "--title", "t",
        "--xrot", "30", "--linewidth", "1.5", "--keypos", "bottom right",
        "--imgfile", out, csvfile], image=out)
    assert j[:3] == t[:3] and t[0] == 0
    assert j[3].startswith(MAGIC[ext]) and t[3].startswith(MAGIC[ext])
    if ext == ".svg":  # the right-axis label made it into both images
        assert b"IOPS last" in j[3] and b"IOPS last" in t[3]


def test_chart_bars_png_with_background(csvfile, tmp_path, capsys):
    out = str(tmp_path / "c.png")
    j, t = _both(capsys, [
        "-x", "block size", "-y", "lat avg us", "--bars",
        "--chartsize", "640,480", "--imgbg", "#ffffff", "--imgfile", out,
        csvfile], image=out)
    assert j[:3] == t[:3] and t[0] == 0
    # the same PNG signature, width and height (IHDR) from both tools
    assert j[3][:24] == t[3][:24] and t[3].startswith(MAGIC[".png"])


def test_chart_unknown_column_fails(csvfile, tmp_path, capsys):
    j, t = _both(capsys, [
        "-x", "nope", "--imgfile", str(tmp_path / "x.svg"), csvfile])
    assert j == t
    assert t[0] == 1 and "not found" in t[2]


def test_chart_unknown_op_fails(csvfile, tmp_path, capsys):
    j, t = _both(capsys, [
        "-y", "MiB/s last:APPEND", "--imgfile", str(tmp_path / "c.svg"),
        csvfile])
    assert j == t
    assert t[0] == 1 and "no rows match" in t[2]


def test_chart_col_with_colon_spec_resolution():
    cols = ["MiB/s last", "operation"]
    for chart in CHARTS:
        assert chart.split_col_op("MiB/s last:READ", cols) == \
            ("MiB/s last", "READ")
        assert chart.split_col_op("MiB/s last", cols) == \
            ("MiB/s last", None)


def test_chart_without_matplotlib_fails_alike(csvfile, tmp_path,
                                              monkeypatch):
    """Where matplotlib is missing, both tools fail with the same cause."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    got = []
    for chart in CHARTS:
        with pytest.raises(ImportError) as e:
            chart.main(["-x", "block size", "-y", "lat avg us",
                        "--imgfile", str(tmp_path / "m.svg"), csvfile])
        got.append(str(e.value))
    assert got[0] == got[1]
    assert not os.path.exists(tmp_path / "m.svg")
