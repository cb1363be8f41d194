"""Render the roofline / dry-run tables from a sweep's JSONL (port of
``repro.launch.roofline_report``): the port's records
(``repro_torch.launch.dryrun``) or the reference's, in the same columns.
The "compile" column shows a port record's ``t_trace_s`` (the time to run
its step on ``meta``) and a reference record's ``t_compile_s``.  The
t_comp / t_mem / t_coll columns are the records' roofline terms, modelled
from peak rates (the port's: the H100 SXM5's data sheet), not measured.

  PYTHONPATH=src python -m repro_torch.launch.roofline_report \
      dryrun.jsonl [--mesh 16x16] [--csv] [--memory]

``--memory`` renders the port's own table instead: per combo and mesh,
whether rank 0 fits the card, its peak, the bytes it holds beside the
bytes under the reference's specs, and the dominant term.
"""
from __future__ import annotations

import argparse
import json
from collections import OrderedDict


def load(path):
    rows = OrderedDict()
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            key = (r.get("arch"), r.get("shape"), r.get("mesh"))
            rows[key] = r            # later lines win (reruns)
    return rows


def fmt_s(x):
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.1f}us"


def fmt_b(x):
    if x is None:
        return "-"
    for unit, div in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= div:
            return f"{x/div:.1f}{unit}"
    return f"{x:.0f}B"


def render(rows, *, mesh="16x16", markdown=True):
    hdr = ["arch", "shape", "t_comp", "t_mem", "t_coll", "dominant",
           "hbm/dev", "flops/dev", "coll", "6ND/HLO", "compile"]
    out = []
    if markdown:
        out.append("| " + " | ".join(hdr) + " |")
        out.append("|" + "---|" * len(hdr))
    for (arch, shape, m), r in rows.items():
        if m != mesh:
            continue
        if "error" in r:
            cells = [arch, shape, "FAIL: " + r["error"][:60]] + [""] * 8
        else:
            rl = r["roofline"]
            mem = r["memory"]
            cells = [
                arch, shape,
                fmt_s(rl["t_compute"]), fmt_s(rl["t_memory"]),
                fmt_s(rl["t_collective"]), rl["dominant"],
                fmt_b(mem.get("peak_bytes")),
                f"{rl['flops']/1e12:.2f}T",
                fmt_b(rl["collective_bytes"]),
                f"{r['useful_flop_ratio']:.2f}" if r.get("useful_flop_ratio")
                else "-",
                f"{r['t_trace_s'] if 't_trace_s' in r else r['t_compile_s']}s",
            ]
        out.append("| " + " | ".join(str(c) for c in cells) + " |"
                   if markdown else ",".join(str(c) for c in cells))
    return "\n".join(out)


def render_memory(rows, meshes=("16x16", "2x16x16")):
    """The port's memory table (a markdown row per arch and shape): for
    each mesh whether rank 0's peak fits the card, the peak, the bytes the
    port holds as arguments beside the bytes under the reference's specs,
    and the dominant roofline term."""
    hdr = ["arch", "shape"] + [f"{m}: fits, peak, held / spec, dominant"
                               for m in meshes]
    out = ["| " + " | ".join(hdr) + " |", "|" + "---|" * len(hdr)]
    combos = list(OrderedDict.fromkeys((a, s) for a, s, _ in rows))
    for arch, shape in combos:
        cells = [arch, shape]
        for m in meshes:
            r = rows.get((arch, shape, m))
            if r is None:
                cells.append("-")
            elif "error" in r:
                cells.append("FAIL: " + r["error"][:60])
            else:
                mem = r["memory"]
                cells.append(f"{'yes' if r['fits'] else 'no'}, "
                             f"{fmt_b(mem['peak_bytes'])}, "
                             f"{fmt_b(mem['argument_bytes'])} / "
                             f"{fmt_b(r['spec_argument_bytes'])}, "
                             f"{r['roofline']['dominant']}")
        out.append("| " + " | ".join(cells) + " |")
    return "\n".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("jsonl")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--csv", action="store_true")
    ap.add_argument("--memory", action="store_true",
                    help="the port's memory table over both meshes instead")
    args = ap.parse_args()
    rows = load(args.jsonl)
    if args.memory:
        print(render_memory(rows))
        return
    print(render(rows, mesh=args.mesh, markdown=not args.csv))
    n_ok = sum(1 for r in rows.values() if "error" not in r)
    n_err = sum(1 for r in rows.values() if "error" in r)
    print(f"\n{n_ok} OK, {n_err} failed, {len(rows)} total combos recorded")


if __name__ == "__main__":
    main()
