#!/usr/bin/env python3
"""Generate the bash completions of the PyTorch/CUDA port's launchers from
the port's own parsers.

The counterpart of tools/gen_completion.py, which renders the original's
completion from elbencho_tpu/config.py: this one reads
elbencho_tpu_torch.config.build_parser() with the value vocabularies of
elbencho_tpu_torch.common, and elbencho_tpu_torch.tools.chart's parser,
so a completion never offers a flag its launcher refuses:

    dist/bash_completion.d/elbencho-tpu-torch        (bin/elbencho-tpu-torch)
    dist/bash_completion.d/elbencho-tpu-torch-chart  (bin/elbencho-tpu-torch-chart)

    python3 tools/torch_gen_completion.py          # rewrite both in place
    python3 tools/torch_gen_completion.py --check  # exit 1 if one is stale

tests/test_torch_tools.py runs the --check comparison.
"""

from __future__ import annotations

import argparse
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

from tools.gen_completion import (_FILE_ARG_OPTS,  # noqa: E402
                                  _visible_option_groups, _wrap)

OUT_DIR = os.path.join(_REPO, "dist", "bash_completion.d")
CLI_OUTPUT = os.path.join(OUT_DIR, "elbencho-tpu-torch")
CHART_OUTPUT = os.path.join(OUT_DIR, "elbencho-tpu-torch-chart")
# chart options completing to filenames (the rest take free-form values)
_CHART_FILE_OPTS = ("--imgfile",)

_BODY = """    local cur prev opts
    COMPREPLY=()
    cur="${{COMP_WORDS[COMP_CWORD]}}"
    prev="${{COMP_WORDS[COMP_CWORD-1]}}"
{opts_block}
    case "$prev" in
{cases}
    esac
    if [[ "$cur" == -* ]]; then
        COMPREPLY=( $(compgen -W "$opts" -- "$cur") )
    else
        COMPREPLY=( $(compgen -f -- "$cur") )
    fi
    return 0"""


def _opts_block(groups: list[list[str]]) -> str:
    """opts="..." with one wrapped paragraph per argument group."""
    lines: list[str] = []
    for g in groups:
        lines.extend(_wrap(g, "          "))
    lines[0] = '    opts="' + lines[0].lstrip()
    lines[-1] += '"'
    return "\n".join(lines)


def _render(command: str, source: str, parser,
            cases: list[tuple[list[str], str]]) -> str:
    """The completion of `command` over `parser`'s visible options, with
    `cases`: (options, shell action) pairs for the value after them."""
    groups = _visible_option_groups(parser)
    all_opts = {o for g in groups for o in g}
    for opts, _action in cases:
        for opt in opts:
            if opt not in all_opts:
                raise SystemExit(f"torch_gen_completion: value-completion "
                                 f"table names {opt}, which {source} does "
                                 "not accept")
    fn = "_" + command.replace("-", "_")
    body = _BODY.format(
        opts_block=_opts_block(groups),
        cases="\n".join(f"        {'|'.join(opts)})\n{action}"
                        for opts, action in cases))
    return f"""# bash completion for {command}
# GENERATED from {source} by
# tools/torch_gen_completion.py - do not edit by hand; rerun the generator
# after changing the CLI.
{fn}() {{
{body}
}}
complete -F {fn} {command}
"""


def _words(action: str) -> str:
    return (f'            COMPREPLY=( $(compgen -W "{action}" -- "$cur") )\n'
            "            return 0;;")


_FILES = ('            COMPREPLY=( $(compgen -f -- "$cur") )\n'
          "            return 0;;")


def render_cli() -> str:
    from elbencho_tpu_torch.common import RAND_ALGO_NAMES, TPU_BACKEND_NAMES
    from elbencho_tpu_torch.config import build_parser

    return _render(
        "elbencho-tpu-torch", "elbencho_tpu_torch/config.py build_parser()",
        build_parser(),
        [(["--tpubackend"], _words(" ".join(TPU_BACKEND_NAMES))),
         (["--randalgo", "--blockvaralgo"],
          _words(" ".join(RAND_ALGO_NAMES))),
         (list(_FILE_ARG_OPTS), _FILES)])


def render_chart() -> str:
    from elbencho_tpu_torch.tools.chart import build_parser

    parser = build_parser()
    # options that take a value: free-form, except the file ones
    valued = [o for g in parser._action_groups for a in g._group_actions
              if a.help != argparse.SUPPRESS and a.nargs != 0
              for o in a.option_strings if o not in _CHART_FILE_OPTS]
    return _render(
        "elbencho-tpu-torch-chart",
        "elbencho_tpu_torch/tools/chart.py build_parser()", parser,
        [(valued, "            return 0;;"),
         (list(_CHART_FILE_OPTS), _FILES)])


def outputs() -> dict[str, str]:
    """Each completion file's path -> its text as the parsers give it."""
    return {CLI_OUTPUT: render_cli(), CHART_OUTPUT: render_chart()}


def main(argv: list[str] | None = None) -> int:
    check = "--check" in (argv if argv is not None else sys.argv[1:])
    stale = 0
    for path, text in outputs().items():
        if check:
            on_disk = open(path).read() if os.path.exists(path) else ""
            if on_disk != text:
                print(f"{path} is stale; rerun tools/torch_gen_completion.py",
                      file=sys.stderr)
                stale = 1
            continue
        with open(path, "w") as f:
            f.write(text)
        print(f"wrote {path}")
    return stale


if __name__ == "__main__":
    sys.exit(main())
