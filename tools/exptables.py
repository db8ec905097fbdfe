"""Render the experiment-grid CSVs (tools-run output in /tmp/expruns) as the
markdown tables.

Input rows are the reference CSV shape plus the audit columns
(name;mean;median;stddev;count[;nruns;ncapped] — experiments.py:_stats_row;
round-4 CSVs lack the last two). Output: one
markdown table per (dataset, query-cell) group with index-off and index-on
columns side by side, so the reference-comparable scan number and the
sidecar-index bonus are readable in one row.

Usage: python tools/exptables.py /tmp/expruns/e1_inproc.csv [more.csv ...]
"""

from __future__ import annotations

import sys
from pathlib import Path


def load(paths: list[str]) -> dict[str, tuple[float, float, float, str, str, int]]:
    """name -> (mean, median, stddev, count, runs_label, ncapped)."""
    rows: dict[str, tuple[float, float, float, str, str, int]] = {}
    for p in paths:
        for line in Path(p).read_text().splitlines():
            if not line.strip():
                continue
            parts = line.split(";")
            name, mean, median, stddev = parts[0], *map(float, parts[1:4])
            count = parts[4] if len(parts) > 4 else ""
            nruns = parts[5] if len(parts) > 5 else ""
            ncapped = int(parts[6]) if len(parts) > 6 else 0
            rows[name] = (mean, median, stddev, count, nruns, ncapped)
    return rows


def render(rows: dict[str, tuple[float, float, float, str]]) -> str:
    # group rows as base-cell -> {plain, indexed}
    cells: dict[str, dict[str, tuple]] = {}
    order: list[str] = []
    for name, v in rows.items():
        base = name[: -len("_indexed")] if name.endswith("_indexed") else name
        kind = "indexed" if name.endswith("_indexed") else "plain"
        if base not in cells:
            cells[base] = {}
            order.append(base)
        cells[base][kind] = v

    out = [
        "| cell | median s (no index) | mean | stddev | median s (indexed) | matches | runs |",
        "|---|---|---|---|---|---|---|",
    ]
    any_capped = False
    for base in order:
        c = cells[base]
        plain = c.get("plain")
        idx = c.get("indexed")
        count = (plain or idx)[3]
        pm = f"{plain[1]:.2f}" if plain else "—"
        pmean = f"{plain[0]:.2f}" if plain else "—"
        psd = f"{plain[2]:.2f}" if plain else "—"
        im = f"{idx[1]:.2f}" if idx else "—"
        runs = (plain or idx)[4]
        ncapped = max(v[5] for v in c.values())
        cap_mark = ""
        if ncapped:
            cap_mark = f" †{ncapped}"
            any_capped = True
        out.append(
            f"| {base} | {pm} | {pmean} | {psd} | {im} | {count} | {runs}{cap_mark} |"
        )
    if any_capped:
        out.append("")
        out.append(
            "†N = N of the cell's runs hit the per-query timeout and are "
            "recorded AT the cap (medians robust, means inflated)."
        )
    return "\n".join(out)


def parity(rows: dict[str, tuple[float, float, float, str]]) -> str:
    """Cross-format count-parity audit: group rows by (cell minus the
    format token) and report any group whose formats disagree. The harness
    already asserts this at run time; this re-checks it from the committed
    CSVs so the tables carry an auditable statement."""
    groups: dict[str, dict[str, str]] = {}
    for name, (_, _, _, count, _, _) in rows.items():
        base = name[: -len("_indexed")] if name.endswith("_indexed") else name
        kind = "_indexed" if name.endswith("_indexed") else ""
        parts = base.split("_")
        fmt = parts[-1]
        cell = "_".join(parts[:-1]) + kind
        groups.setdefault(cell, {})[fmt] = count
    bad = {c: f for c, f in groups.items() if len(set(f.values())) > 1}
    if bad:
        lines = ["PARITY FAILURES:"]
        for c, f in sorted(bad.items()):
            lines.append(f"  {c}: {f}")
        return "\n".join(lines)
    n = len(groups)
    return (f"cross-format count parity: OK — {n} cells, every format "
            f"reports the identical match count")


def compare_backends(a_paths: list[str], b_paths: list[str]) -> str:
    """Counts must agree row-for-row between two table sets (e.g. the CPU
    cold grid and the in-process grid) wherever both measured a cell."""
    a, b = load(a_paths), load(b_paths)
    common = sorted(set(a) & set(b))
    bad = [n for n in common if a[n][3] != b[n][3] and a[n][3] and b[n][3]]
    if bad:
        return "BACKEND COUNT MISMATCHES:\n" + "\n".join(
            f"  {n}: {a[n][3]} vs {b[n][3]}" for n in bad)
    return (f"cross-backend count parity: OK — {len(common)} shared cells, "
            f"identical match counts")


if __name__ == "__main__":
    if "--compare" in sys.argv:
        i = sys.argv.index("--compare")
        print(compare_backends(sys.argv[1:i], sys.argv[i + 1:]))
    else:
        rows = load(sys.argv[1:])
        print(render(rows))
        print()
        print(parity(rows))
