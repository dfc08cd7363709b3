"""The comparison can fail: the control and each planted fault come out
not correct, a sound run of the same cell correct. On the mock, at the
small size; the same variants run on the card at the cells' own size with
python3 -m benchmark.control."""

from __future__ import annotations

import pytest

from benchmark import control, spec

CELLS = ("unet3d-1gpu.stream",)

# each number compared, and the variants that give it its upper reading
UPPER = [
    ("unet3d-1gpu.stream", "control", ["verify_launch_gap"]),
    ("unet3d-1gpu.stream", "unchanged",
     ["landed_bytes_gap", "copies_gap", "verify_launch_gap",
      "corrupt_offset_gap"]),
    ("unet3d-1gpu.stream", "half",
     ["landed_bytes_gap", "copies_gap", "verify_launch_gap"]),
    ("unet3d-1gpu.stream", "altered", ["phase_errors", "landed_bytes_gap"]),
    ("unet3d-1gpu.stream", "fail", ["phase_errors", "landed_bytes_gap"]),
]


def _variant(root, workload, variant, seed=2147483659):
    cell = spec.load_cell(workload, str(root))
    with open(root / "port.log", "a") as log:
        return control.run_variant(cell, variant, seed, 0.3, str(root),
                                   log=log)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(small_root, mock_env, workload):
    out = _variant(small_root, workload, "none")
    assert out["correct"], out["checks"]
    # every number the cell compares has an upper reading in UPPER
    assert set(out["checks"]) == {n for w, _, fails in UPPER
                                  if w == workload for n in fails}


@pytest.mark.parametrize("workload,variant,fails", UPPER)
def test_variant_is_not_correct(small_root, mock_env, workload,
                                variant, fails):
    out = _variant(small_root, workload, variant)
    assert not out["correct"]
    for name in fails:
        assert out["checks"][name]["value"] > out["checks"][name]["limit"], \
            (name, out["checks"])
