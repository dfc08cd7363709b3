"""The port's companion tools held against the original's.

- tools/torch_gen_completion.py renders dist/bash_completion.d/
  elbencho-tpu-torch and elbencho-tpu-torch-chart from the port's parsers:
  each lists every option of its parser, and the same options as the
  original's completion (the port accepts every flag of the original) but
  for the port's own (PORT_ONLY_OPTIONS); the committed files are what the
  generator renders.
- bin/elbencho-tpu-torch-chart launches the port's chart tool.
- tools/torch_storage_sweep.sh plans, in its dry run, the original's sweep
  (tools/storage-sweep.sh) with the launchers' names swapped, for each
  range and for a bad one.
- tools/torch_test_examples.sh runs its tiers on the mock CUDA driver, and
  with --card refuses without a CUDA device.
- tools/torch_baseline_configs.sh, torch_blockdev_rand.sh and
  torch_record_distributed_evidence.sh compose the original's script with
  only their lines swapped (a `bash` on PATH that records the script),
  refuse when one of those lines moved (a patched copy), and, with stub
  launchers, run the original's commands on the port's launcher; the
  block-device tool refuses a non-block device and a mounted one for
  write word for word with the original.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools import torch_gen_completion  # noqa: E402

COMPLETIONS = os.path.join(REPO, "dist", "bash_completion.d")
# options of the port that the original does not have: --spanfile writes
# the port's span log (elbencho_tpu_torch/spans.py)
PORT_ONLY_OPTIONS = {"elbencho-tpu-torch": {"--spanfile"}}
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
    assert _long_options(words) - PORT_ONLY_OPTIONS.get(port_file, set()) \
        == _long_options(_completion_words(original_file))
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


# ------------------------------------------- the last three companion tools

# each port tool: the original it reads, and {original line: its swap}
COMPOSED = {
    "torch_baseline_configs.sh": ("baseline-configs.sh", {
        'EB="$REPO/bin/elbencho-tpu"': 'EB="$REPO/bin/elbencho-tpu-torch"',
        'OUT="${2:-$REPO/results/baseline-configs/$(date +%F)}"':
            'OUT="${2:-$REPO/results/torch-baseline-configs/$(date +%F)}"',
    }),
    "torch_blockdev_rand.sh": ("blockdev-rand.sh", {
        'EB="./bin/elbencho-tpu"': 'EB="./bin/elbencho-tpu-torch"',
    }),
    "torch_record_distributed_evidence.sh": (
        "record-distributed-evidence.sh", {
            'OUT="results/distributed/$DATE"':
                'OUT="results/torch_distributed/$DATE"',
            '  echo "# two localhost services + master, --tpubackend pjrt, '
            '1 real TPU"':
                '  echo "# two localhost port services + master, '
                '--tpubackend pjrt (native CUDA engine), 1 GPU"',
            **{ln: ln.replace("./bin/elbencho-tpu ",
                              "./bin/elbencho-tpu-torch ")
               for ln in open(os.path.join(
                   REPO, "tools", "record-distributed-evidence.sh"))
               .read().splitlines() if "./bin/elbencho-tpu " in ln},
        }),
}


def _fake_bash(tmp_path) -> dict[str, str]:
    """An environment whose `bash` writes the script it is given (-c) to
    $CAPTURE instead of running it."""
    d = tmp_path / "fakebin"
    d.mkdir()
    (d / "bash").write_text('#!/bin/sh\nprintf "%s" "$2" > "$CAPTURE"\n')
    (d / "bash").chmod(0o755)
    return {**os.environ, "PATH": f"{d}:{os.environ['PATH']}",
            "CAPTURE": str(tmp_path / "script")}


def _compose(tools_dir, tool, tmp_path) -> tuple[int, str, str | None]:
    """(exit code, output, the script it composed or None)."""
    r = subprocess.run([shutil.which("bash"), os.path.join(tools_dir, tool)],
                       env=_fake_bash(tmp_path), capture_output=True,
                       text=True, timeout=60)
    cap = tmp_path / "script"
    return r.returncode, r.stdout + r.stderr, \
        cap.read_text() if cap.exists() else None


@pytest.mark.parametrize("tool", sorted(COMPOSED))
def test_tool_runs_the_original_with_only_its_lines_swapped(tool, tmp_path):
    original, swaps = COMPOSED[tool]
    rc, out, script = _compose(os.path.join(REPO, "tools"), tool, tmp_path)
    assert rc == 0 and script is not None, out
    want = [swaps.get(ln, ln) for ln in open(
        os.path.join(REPO, "tools", original)).read().splitlines()]
    assert script.splitlines() == want
    assert sum(a != b for a, b in zip(
        open(os.path.join(REPO, "tools", original)).read().splitlines(),
        want)) == len(swaps)


@pytest.mark.parametrize("tool,index", [
    (tool, i) for tool in sorted(COMPOSED)
    for i in range(len(COMPOSED[tool][1]))])
def test_tool_refuses_when_the_originals_line_moves(tool, index, tmp_path):
    """A patched copy of the original whose line to swap reads otherwise:
    the tool aborts and runs nothing."""
    original, swaps = COMPOSED[tool]
    moved = sorted(swaps)[index]
    tools = tmp_path / "tools"
    tools.mkdir()
    shutil.copy2(os.path.join(REPO, "tools", tool), tools / tool)
    text = open(os.path.join(REPO, "tools", original)).read()
    assert text.count(moved + "\n") == 1
    (tools / original).write_text(text.replace(moved + "\n",
                                               "  " + moved + "\n"))
    rc, out, script = _compose(str(tools), tool, tmp_path)
    assert rc == 1 and script is None
    assert f"tools/{original} no longer" in out and "Abort!" in out


def _stubbed_tree(tmp_path, *tools) -> str:
    """tmp_path with copies of `tools` and stub launchers that log their
    name and arguments to $STUB_LOG (nothing is read or written)."""
    (tmp_path / "tools").mkdir()
    for t in tools:
        shutil.copy2(os.path.join(REPO, "tools", t), tmp_path / "tools" / t)
    (tmp_path / "bin").mkdir()
    for name in ("elbencho-tpu", "elbencho-tpu-torch"):
        stub = tmp_path / "bin" / name
        stub.write_text('#!/bin/sh\necho "$(basename "$0") $*" '
                        '>> "$STUB_LOG"\n')
        stub.chmod(0o755)
    return str(tmp_path)


def _stub_run(tree, tool, log, *args) -> subprocess.CompletedProcess:
    return subprocess.run(["bash", os.path.join(tree, "tools", tool), *args],
                          env={**os.environ, "STUB_LOG": str(log)},
                          capture_output=True, text=True, timeout=120)


def _mounted_block_device() -> str | None:
    import stat

    for line in open("/proc/mounts"):
        dev = line.split()[0]
        try:
            if dev.startswith("/dev/") and \
                    stat.S_ISBLK(os.stat(dev).st_mode):
                return dev
        except OSError:
            continue
    return None


def test_blockdev_tool_refuses_a_non_block_device_as_the_original():
    runs = [subprocess.run(["bash", os.path.join(REPO, "tools", t), "-D",
                            "/dev/null", "-m", "write"], capture_output=True,
                           text=True, timeout=60)
            for t in ("blockdev-rand.sh", "torch_blockdev_rand.sh")]
    assert runs[0].returncode == runs[1].returncode == 1
    assert runs[0].stdout == runs[1].stdout == \
        "error: /dev/null is not a block device\n"


@pytest.mark.parametrize("mode", ["write", "rwmix"])
def test_blockdev_tool_refuses_a_mounted_device_as_the_original(tmp_path,
                                                               mode):
    """Word for word the original's guard, in a tree whose launchers are
    stubs (so a guard that failed would still write nothing)."""
    dev = _mounted_block_device()
    if dev is None:
        pytest.skip("no mounted block device on this host")
    tree = _stubbed_tree(tmp_path, "blockdev-rand.sh",
                         "torch_blockdev_rand.sh")
    log = tmp_path / "calls"
    runs = [_stub_run(tree, t, log, "-D", dev, "-m", mode)
            for t in ("blockdev-rand.sh", "torch_blockdev_rand.sh")]
    assert runs[0].returncode == runs[1].returncode == 1
    assert runs[0].stdout == runs[1].stdout == \
        f"error: {dev} (or a partition) is mounted - refusing to write\n"
    assert not log.exists()


def test_blockdev_tool_read_runs_the_port_launcher(tmp_path):
    dev = _mounted_block_device()
    if dev is None:
        pytest.skip("no block device on this host")
    tree = _stubbed_tree(tmp_path, "blockdev-rand.sh",
                         "torch_blockdev_rand.sh")
    logs = []
    for t in ("blockdev-rand.sh", "torch_blockdev_rand.sh"):
        log = tmp_path / f"{t}.calls"
        r = _stub_run(tree, t, log, "-D", dev, "-b", "8k", "-q", "4")
        assert r.returncode == 0, r.stdout + r.stderr
        logs.append(log.read_text())
    assert logs[0].startswith("elbencho-tpu -r --rand --randalign -b 8k")
    assert logs[1] == logs[0].replace("elbencho-tpu ",
                                      "elbencho-tpu-torch ", 1)


def test_baseline_tool_runs_the_originals_configs_on_the_port(tmp_path):
    """With stub launchers: the same commands in the same order as the
    original, each on bin/elbencho-tpu-torch, and the default archive
    under results/torch-baseline-configs/<date>/."""
    tree = _stubbed_tree(tmp_path, "baseline-configs.sh",
                         "torch_baseline_configs.sh")
    work = tmp_path / "work"
    work.mkdir()
    calls = []
    for t in ("baseline-configs.sh", "torch_baseline_configs.sh"):
        log = tmp_path / f"{t}.calls"
        r = _stub_run(tree, t, log, str(work))
        assert r.returncode == 0, r.stdout + r.stderr
        calls.append(re.sub(r"ebt-baseline\.\d+", "ebt-baseline.PID",
                            log.read_text()))
    assert len(calls[0].splitlines()) == 14  # 1 + 3, 1 + 2 x 3, 3
    assert calls[1] == calls[0].replace("elbencho-tpu ",
                                        "elbencho-tpu-torch ")
    archives = sorted(os.listdir(tmp_path / "results"))
    assert archives == ["baseline-configs", "torch-baseline-configs"]
    for a in archives:
        (day,) = os.listdir(tmp_path / "results" / a)
        assert re.fullmatch(r"\d{4}-\d\d-\d\d", day)
        assert os.path.exists(tmp_path / "results" / a / day / "SUMMARY.txt")
    assert os.listdir(work) == []
