"""The port's companion tools held against the original's.

- tools/torch_gen_completion.py renders dist/bash_completion.d/
  elbencho-tpu-torch and elbencho-tpu-torch-chart from the port's parsers:
  each lists every option of its parser, and the same options as the
  original's completion (the port accepts every flag of the original); the
  committed files are what the generator renders.
- bin/elbencho-tpu-torch-chart launches the port's chart tool.
- tools/torch_storage_sweep.sh plans, in its dry run, the original's sweep
  (tools/storage-sweep.sh) with the launchers' names swapped, for each
  range and for a bad one.
- tools/torch_test_examples.sh runs its tiers on the mock CUDA driver, and
  with --card refuses without a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools import torch_gen_completion  # noqa: E402

COMPLETIONS = os.path.join(REPO, "dist", "bash_completion.d")
HARNESS = os.path.join(REPO, "tools", "torch_test_examples.sh")


def _visible_options(parser) -> list[str]:
    return [o for a in parser._actions if a.help != argparse.SUPPRESS
            for o in a.option_strings]


def _completion_words(name: str) -> set[str]:
    text = open(os.path.join(COMPLETIONS, name)).read()
    for sep in ("|", "\\", '"', "(", ")"):
        text = text.replace(sep, " ")
    return set(text.split())


def _long_options(words: set[str]) -> set[str]:
    return {w for w in words if re.fullmatch(r"--[A-Za-z0-9][A-Za-z0-9-]+", w)}


@pytest.mark.parametrize("port_file,original_file,parser_module", [
    ("elbencho-tpu-torch", "elbencho-tpu", "elbencho_tpu_torch.config"),
    ("elbencho-tpu-torch-chart", "elbencho-tpu-chart",
     "elbencho_tpu_torch.tools.chart"),
])
def test_completion_lists_the_port_parser_and_the_original_options(
        port_file, original_file, parser_module):
    """Every visible option of the port's parser is offered, no long option
    it lacks is, and the options are the original completion's."""
    import importlib

    parser = importlib.import_module(parser_module).build_parser()
    opts = _visible_options(parser)
    words = _completion_words(port_file)
    assert not [o for o in opts if o not in words]
    assert _long_options(words) == set(o for o in opts if o.startswith("--"))
    assert _long_options(words) == _long_options(
        _completion_words(original_file))
    assert f"complete -F _{port_file.replace('-', '_')} {port_file}" in \
        open(os.path.join(COMPLETIONS, port_file)).read()


@pytest.mark.parametrize("path", sorted(torch_gen_completion.outputs()),
                         ids=os.path.basename)
def test_committed_completion_is_a_fresh_render(path):
    assert open(path).read() == torch_gen_completion.outputs()[path]


def test_completion_check_mode_flags_a_stale_file(tmp_path, monkeypatch,
                                                  capsys):
    stale = tmp_path / "elbencho-tpu-torch"
    stale.write_text("# stale\n")
    chart = tmp_path / "elbencho-tpu-torch-chart"
    chart.write_text(open(torch_gen_completion.CHART_OUTPUT).read())
    monkeypatch.setattr(torch_gen_completion, "CLI_OUTPUT", str(stale))
    monkeypatch.setattr(torch_gen_completion, "CHART_OUTPUT", str(chart))
    assert torch_gen_completion.main(["--check"]) == 1
    assert "is stale" in capsys.readouterr().err
    assert torch_gen_completion.main([]) == 0
    assert torch_gen_completion.main(["--check"]) == 0


def test_chart_launcher_runs_the_port_chart():
    r = subprocess.run([os.path.join(REPO, "bin", "elbencho-tpu-torch-chart"),
                        "--help"], capture_output=True, text=True,
                       cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "usage: elbencho-tpu-torch-chart" in r.stdout


def _sweep(script: str, *args):
    return subprocess.run(["bash", os.path.join(REPO, "tools", script), *args],
                          capture_output=True, text=True, cwd=REPO,
                          timeout=120)


@pytest.mark.parametrize("args", [
    ("-r", "s", "-t", "4", "-F", "64", "-N", "1"),
    ("-r", "m", "-t", "4", "-F", "1024", "-N", "1"),
    ("-r", "l", "-t", "2", "-F", "2048", "-N", "1"),
    ("-r", "x"),
], ids=["s", "m", "l", "bad-range"])
def test_sweep_plan_is_the_originals_over_the_port(args, tmp_path):
    """The dry-run plan (or the refusal) of the port's sweep is the
    original's, word for word, with the port's launchers in it."""
    common = ("-n", "-s", str(tmp_path), "-o", str(tmp_path / "out"))
    orig = _sweep("storage-sweep.sh", *common, *args)
    port = _sweep("torch_storage_sweep.sh", *common, *args)
    assert port.returncode == orig.returncode
    want = orig.stdout.replace("bin/elbencho-tpu ",
                               "bin/elbencho-tpu-torch ")
    assert port.stdout == want
    if args[1] == "x":
        assert port.returncode == 1 and "Abort" in port.stdout
    else:
        assert port.returncode == 0
        lines = port.stdout.splitlines()
        assert lines and all(ln.startswith("./bin/elbencho-tpu-torch ")
                             for ln in lines)


def _harness(*flags, timeout):
    return subprocess.run(["bash", HARNESS, *flags], capture_output=True,
                          text=True, cwd=REPO, timeout=timeout)


def _tiers(out: str) -> dict[str, str]:
    return dict(re.findall(r"^TIER (\w+) (\w+) [\d.]+$", out, re.M))


def test_harness_local_tiers_on_the_mock():
    """-b -d: the multi-file, tooling and native tiers pass, the native runs
    on the port's mock CUDA driver."""
    r = _harness("-b", "-d", timeout=240)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
    assert _tiers(r.stdout) == {"multifile": "pass", "tooling": "pass",
                                "native": "pass"}
    assert "native CUDA tier: zero-copy" in r.stdout + r.stderr
    assert "native CUDA transfer-manager tier" in r.stdout + r.stderr
    assert "ALL TESTS PASSED" in r.stdout


def test_harness_distributed_tiers_on_the_mock():
    """-b -m -t: two services, four services on the native path with the
    --start barrier and a time-limited phase, and the slice-stats tier."""
    r = _harness("-b", "-m", "-t", timeout=240)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
    assert _tiers(r.stdout) == {"dist2": "pass", "dist4": "pass",
                                "mesh": "pass"}


def test_harness_card_mode_refuses_without_a_card():
    """--card runs the native tier on the CUDA driver; with no CUDA device
    it fails with the port's own refusal, and nothing falls back to the
    mock."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --card would run on it")
    r = _harness("--card", "-b", "-d", "-m", timeout=240)
    assert r.returncode == 1
    assert _tiers(r.stdout) == {"tooling": "pass", "native": "fail"}
    assert "no CUDA device found (set EBT_TORCH_DEVICE=cpu" in \
        r.stdout + r.stderr
    assert "--gpuids 0" in r.stdout
    assert "native CUDA tier" not in r.stdout + r.stderr


def test_harness_rejects_an_unknown_flag():
    r = _harness("-x", timeout=60)
    assert r.returncode == 1
    assert "usage:" in r.stdout
