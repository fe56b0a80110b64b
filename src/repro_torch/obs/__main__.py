"""CLI over saved traces: ``python -m repro_torch.obs summarize|export ...``.

summarize  per-span-name aggregates (count, total/mean/max ms), the
           stage-name set, and the root span's child coverage — the same
           numbers the CI obs gate checks.
export     filter/normalize a saved Chrome-trace JSON (name prefix,
           minimum duration) into a smaller file that still opens in
           chrome://tracing or https://ui.perfetto.dev.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import trace as obstrace


def _cmd_summarize(args) -> int:
    doc = obstrace.load(args.trace)
    rows = obstrace.summarize(doc)
    if not rows:
        print("no complete span events in trace")
        return 1
    w = max(len(r["name"]) for r in rows)
    print(f"{'span':<{w}}  {'count':>7}  {'total_ms':>10}  "
          f"{'mean_ms':>9}  {'max_ms':>9}")
    for r in rows:
        print(f"{r['name']:<{w}}  {r['count']:>7}  {r['total_ms']:>10.3f}  "
              f"{r['mean_ms']:>9.3f}  {r['max_ms']:>9.3f}")
    cov = obstrace.coverage(doc, root=args.root)
    print(f"\n{args.root} child coverage: {cov:.1%} "
          f"(stage durations / root wall, last occurrence)")
    return 0


def _cmd_export(args) -> int:
    doc = obstrace.load(args.trace)
    events = doc.get("traceEvents", [])
    kept = [e for e in events
            if e.get("ph") != "X"
            or (e.get("dur", 0.0) >= args.min_dur_us
                and (not args.filter or e["name"].startswith(args.filter)))]
    out = {"displayTimeUnit": doc.get("displayTimeUnit", "ms"),
           "traceEvents": kept}
    with open(args.out, "w") as f:
        json.dump(out, f)
    n_x = sum(1 for e in kept if e.get("ph") == "X")
    print(f"wrote {args.out}: {n_x} span events "
          f"(of {sum(1 for e in events if e.get('ph') == 'X')})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="inspect traces exported by repro_torch.obs.trace")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("summarize", help="per-span aggregates + coverage")
    s.add_argument("trace", help="Chrome-trace JSON from Tracer.export")
    s.add_argument("--root", default="engine.run",
                   help="root span for the coverage readout")
    s.set_defaults(fn=_cmd_summarize)

    e = sub.add_parser("export", help="filter a trace into a smaller file")
    e.add_argument("trace", help="Chrome-trace JSON from Tracer.export")
    e.add_argument("-o", "--out", required=True)
    e.add_argument("--filter", default="",
                   help="keep only span names with this prefix")
    e.add_argument("--min-dur-us", type=float, default=0.0,
                   help="drop spans shorter than this many microseconds")
    e.set_defaults(fn=_cmd_export)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
