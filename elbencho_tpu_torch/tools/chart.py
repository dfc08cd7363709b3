"""elbencho-tpu-torch-chart: plot benchmark CSV results (the port's copy of
the original package's chart tool, elbencho_tpu/tools/chart.py; it reads the
CSV files both packages write, --csvfile, and imports nothing of either).

Rebuild of the reference's dist/usr/bin/elbencho-chart (a 730-line gnuplot
wrapper; option surface at elbencho-chart:40-98). matplotlib replaces gnuplot;
the flag set mirrors the reference:

  -c                   list available CSV columns and exit
  -o                   list available operations and exit
  -x COL               x-axis label column (repeatable -> combined labels)
  -y COL[:OP]          graph on left y-axis, optional operation filter
  -Y COL[:OP]          graph on right-hand y-axis (twin axis)
  --bars               grouped bar chart instead of lines
  --chartsize W,H      chart size in pixels (pdf: inches, like the reference)
  --fontsize N         base font size
  --imgfile PATH       output image; extension picks svg/png/pdf
  --imgbg RGB          opaque background color (default transparent)
  --keypos STR         legend position (gnuplot-style, e.g. "top center")
  --linewidth N        line width
  --title STR          chart title
  --xrot DEG           x tick label rotation
  --xtitle/--ytitle/--Ytitle  axis titles

Colors are the validated fixed-order categorical palette from the dataviz
reference instance (light mode); series colors follow declaration order,
never recycled per chart.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys

# fixed categorical order; series beyond the palette reuse it with dashes
PALETTE = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4", "#008300",
           "#4a3aa7", "#e34948"]
TEXT_PRIMARY = "#1a1a19"
TEXT_SECONDARY = "#5f5e58"
GRID = "#e4e3dd"

# gnuplot key positions -> matplotlib legend loc
KEYPOS_MAP = {
    "top center": "upper center", "top left": "upper left",
    "top right": "upper right", "bottom center": "lower center",
    "bottom left": "lower left", "bottom right": "lower right",
    "center": "center", "left": "center left", "right": "center right",
}


def read_rows(paths: list[str]) -> list[dict]:
    rows: list[dict] = []
    for p in paths:
        with open(p, newline="") as f:
            rows.extend(csv.DictReader(f))
    return rows


def numeric(v: str) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return float("nan")


def resolve_col(name: str, columns: list[str]) -> str | None:
    """Exact match first, then case-insensitive (the reference resolves
    column names by exact string compare against the CSV header; we add the
    case-insensitive fallback for convenience)."""
    if name in columns:
        return name
    lowered = {c.lower(): c for c in columns}
    return lowered.get(name.lower())


def split_col_op(spec: str, columns: list[str]) -> tuple[str, str | None]:
    """Parse the reference's COL[:OP] series spec. A colon only splits when
    the full string is not itself a column name (column titles may contain
    colons in principle; exact matches win)."""
    if spec in columns:
        return spec, None
    col, sep, op = spec.rpartition(":")
    if sep and resolve_col(col, columns):
        return col, op
    return spec, None


class Series:
    def __init__(self, spec: str, columns: list[str], side: str):
        col, op = split_col_op(spec, columns)
        resolved = resolve_col(col, columns)
        if resolved is None:
            raise SystemExit(
                f"column {col!r} not found in csv file. "
                f"Available columns: {', '.join(columns)}")
        self.col = resolved
        self.op = op
        self.side = side

    @property
    def label(self) -> str:
        return f"{self.col} {self.op}" if self.op else self.col


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="elbencho-tpu-torch-chart",
        description="Generate chart from elbencho-tpu csv result file.",
        epilog='Example: elbencho-tpu-torch-chart -x "block size" '
               '-y "MiB/s last:READ" -Y "IOPS last:READ" results.csv')
    p.add_argument("csvfiles", nargs="+", metavar="CSVFILE",
                   help="Path to elbencho-tpu results csv file(s).")
    p.add_argument("-c", dest="list_columns", action="store_true",
                   help="List all available columns in csv file and exit.")
    p.add_argument("-o", dest="list_ops", action="store_true",
                   help="List all available operations in csv file and exit.")
    p.add_argument("-x", dest="xcols", action="append", default=[],
                   metavar="COL",
                   help="Csv column for x-axis labels. Repeatable for "
                        "combined labels.")
    p.add_argument("-y", dest="ycols", action="append", default=[],
                   metavar="COL[:OP]",
                   help="Csv column for a graph on the left y-axis, with "
                        "optional operation filter (e.g. 'MiB/s last:READ'). "
                        "Repeatable for multiple graphs.")
    p.add_argument("-Y", dest="y2cols", action="append", default=[],
                   metavar="COL[:OP]",
                   help="Csv column for a graph on the right-hand y-axis. "
                        "Repeatable.")
    p.add_argument("--bars", action="store_true",
                   help="Generate bar chart. Default is line chart.")
    p.add_argument("--chartsize", default="", metavar="W,H",
                   help="Chart width and height in pixels "
                        "(pdf output: inches).")
    p.add_argument("--fontsize", type=float, default=0, metavar="NUM",
                   help="Font size.")
    p.add_argument("--imgfile", default="", metavar="PATH",
                   help="Output image file; extension picks the type "
                        "(.svg/.png/.pdf). Default: chart.svg")
    p.add_argument("--imgbg", default="", metavar="RGB",
                   help='Opaque image background color (e.g. "#ffffff"). '
                        "Default is transparent.")
    p.add_argument("--keypos", default="top center", metavar="STRING",
                   help='Legend position, e.g. "top center" (default), '
                        '"bottom right".')
    p.add_argument("--linewidth", type=float, default=2, metavar="NUM",
                   help="Line width. (Default: 2)")
    p.add_argument("--title", default="", metavar="STRING",
                   help="Chart title.")
    p.add_argument("--xrot", type=float, default=0, metavar="NUM",
                   help="Rotate x-axis tick labels by given degrees.")
    p.add_argument("--xtitle", default="", metavar="STRING",
                   help="Title for x-axis.")
    p.add_argument("--ytitle", default="", metavar="STRING",
                   help="Title for left-hand y-axis.")
    p.add_argument("--Ytitle", dest="y2title", default="", metavar="STRING",
                   help="Title for right-hand y-axis.")
    # compatibility aliases kept from the first-round tool
    p.add_argument("-t", dest="title_alias", default="", help=argparse.SUPPRESS)
    p.add_argument("-f", dest="filterop", default="", help=argparse.SUPPRESS)
    return p


def main(argv: list[str] | None = None) -> int:
    ns = build_parser().parse_args(argv)

    rows = read_rows(ns.csvfiles)
    if not rows:
        print("no rows in csv input", file=sys.stderr)
        return 1
    columns = list(rows[0].keys())
    opcol = resolve_col("operation", columns)

    if ns.list_columns:
        print("\n".join(columns))
        return 0
    if ns.list_ops:
        if opcol is None:
            print("no operation column in csv file", file=sys.stderr)
            return 1
        seen: list[str] = []
        for r in rows:
            v = r.get(opcol, "")
            if v and v not in seen:
                seen.append(v)
        print("\n".join(seen))
        return 0

    if not ns.title and ns.title_alias:
        ns.title = ns.title_alias

    if not ns.xcols:
        ns.xcols = ["block size"] if resolve_col("block size", columns) \
            else [columns[0]]
    if not ns.ycols and not ns.y2cols:
        default_y = resolve_col("MiB/s last", columns) or columns[-1]
        ns.ycols = [default_y]

    xcols = []
    for xc in ns.xcols:
        resolved = resolve_col(xc, columns)
        if resolved is None:
            print(f"column {xc!r} not found; available: "
                  f"{', '.join(columns)}", file=sys.stderr)
            return 1
        xcols.append(resolved)

    try:
        series = ([Series(s, columns, "left") for s in ns.ycols] +
                  [Series(s, columns, "right") for s in ns.y2cols])
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 1

    if ns.filterop:  # global filter alias applies to series without one
        for s in series:
            s.op = s.op or ns.filterop

    # a series without an op filter on a CSV holding several operations
    # would mix WRITE and READ values at each x position — split it into
    # one series per operation instead
    ops_present: list[str] = []
    if opcol is not None:
        for r in rows:
            v = r.get(opcol, "")
            if v and v not in ops_present:
                ops_present.append(v)
    if len(ops_present) > 1:
        expanded: list[Series] = []
        for s in series:
            if s.op is None:
                for op in ops_present:
                    per_op = Series(s.col, columns, s.side)
                    per_op.op = op
                    expanded.append(per_op)
            else:
                expanded.append(s)
        series = expanded

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if ns.fontsize:
        plt.rcParams.update({"font.size": ns.fontsize})

    out = ns.imgfile or "chart.svg"
    dpi = 100.0
    figsize = (8.0, 4.5)
    if ns.chartsize:
        try:
            w, h = (float(v) for v in ns.chartsize.split(","))
        except ValueError:
            print(f"invalid --chartsize {ns.chartsize!r}; expected W,H",
                  file=sys.stderr)
            return 1
        # reference semantics: pixels, except pdf output takes inches
        figsize = (w, h) if out.endswith(".pdf") else (w / dpi, h / dpi)

    fig, ax = plt.subplots(figsize=figsize)
    ax2 = ax.twinx() if any(s.side == "right" for s in series) else None

    def xlabel_of(row: dict) -> str:
        return " ".join(str(row.get(c, "")) for c in xcols)

    # one global ordered category list so every series aligns to the same
    # x positions even when op filters select different row subsets
    categories: list[str] = []
    for row in rows:
        v = xlabel_of(row)
        if v not in categories:
            categories.append(v)
    cat_pos = {c: i for i, c in enumerate(categories)}

    handles, labels = [], []
    nbars = len(series)
    for i, s in enumerate(series):
        sel = rows
        if s.op is not None:
            if opcol is None:
                print("operation filter given but csv has no operation "
                      "column", file=sys.stderr)
                return 1
            sel = [r for r in rows if r.get(opcol, "") == s.op]
            if not sel:
                print(f"no rows match operation {s.op!r}", file=sys.stderr)
                return 1
        pos = [cat_pos[xlabel_of(r)] for r in sel]
        ys = [numeric(r.get(s.col, "")) for r in sel]
        axis = ax2 if s.side == "right" else ax
        color = PALETTE[i % len(PALETTE)]
        if ns.bars:
            width = 0.8 / nbars
            offs = [j - 0.4 + (i + 0.5) * width for j in pos]
            h = axis.bar(offs, ys, width=width * 0.92, color=color,
                         label=s.label, edgecolor="white", linewidth=0.5)
        else:
            style = "-" if i < len(PALETTE) else "--"
            (h,) = axis.plot(pos, ys, style, color=color, label=s.label,
                             linewidth=ns.linewidth, marker="o",
                             markersize=2.5 * ns.linewidth)
        handles.append(h)
        labels.append(s.label)

    ax.set_xticks(range(len(categories)), categories)
    if ns.xrot:
        plt.setp(ax.get_xticklabels(), rotation=ns.xrot,
                 ha="right" if 0 < ns.xrot < 90 else "center")
    elif any(len(c) > 6 for c in categories) or len(categories) > 8:
        plt.setp(ax.get_xticklabels(), rotation=45, ha="right")

    ax.set_xlabel(ns.xtitle or " / ".join(xcols), color=TEXT_PRIMARY)
    ax.set_ylabel(ns.ytitle or
                  ", ".join(s.label for s in series if s.side == "left"),
                  color=TEXT_PRIMARY)
    if ax2 is not None:
        ax2.set_ylabel(ns.y2title or
                       ", ".join(s.label for s in series if s.side == "right"),
                       color=TEXT_PRIMARY)
        ax2.tick_params(colors=TEXT_SECONDARY, labelsize=9)
        ax2.spines["top"].set_visible(False)
        for spine in ("left", "right", "bottom"):
            ax2.spines[spine].set_color(GRID)
    if ns.title:
        ax.set_title(ns.title, color=TEXT_PRIMARY, fontsize=12, pad=12)
    ax.grid(True, axis="y", color=GRID, linewidth=0.8)
    ax.set_axisbelow(True)
    ax.spines["top"].set_visible(False)
    if ax2 is None:
        ax.spines["right"].set_visible(False)
    for spine in ("left", "bottom"):
        ax.spines[spine].set_color(GRID)
    ax.tick_params(colors=TEXT_SECONDARY, labelsize=9)
    if len(series) > 1:
        loc = KEYPOS_MAP.get(ns.keypos.strip().lower(), "upper center")
        ax.legend(handles, labels, loc=loc, frameon=False, fontsize=9,
                  labelcolor=TEXT_PRIMARY)

    fig.tight_layout()
    save_kw = {"dpi": dpi}
    if ns.imgbg:
        fig.patch.set_facecolor(ns.imgbg)
        save_kw["facecolor"] = ns.imgbg
    else:
        save_kw["transparent"] = True
    fig.savefig(out, **save_kw)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    try:
        rc = main()
        sys.stdout.flush()  # surface EPIPE here, not in the shutdown flush
        sys.exit(rc)
    except BrokenPipeError:  # e.g. `... -c file.csv | head`
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
