"""CLI for the analyzer driver: `python -m easydist_tpu_torch.analyze`
(the JAX package's flags, plus `--device {cuda,cpu}`: where the
`presets` target compiles, the card by default).

Exit status is the gate: 0 when every error-severity finding is
baselined (or none exist), 1 when NEW errors appear.  `EASYDIST_ANALYZE=0`
skips every layer and exits 0 (the kill switch must win over the gate).

Examples:
    python -m easydist_tpu_torch.analyze --targets ast
    python -m easydist_tpu_torch.analyze --targets protocol --json out.json
    python -m easydist_tpu_torch.analyze --device cpu --targets ast,protocol,presets
    python -m easydist_tpu_torch.analyze --refresh-baseline
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m easydist_tpu_torch.analyze",
        description="easydist_tpu_torch static analyzer driver")
    parser.add_argument("--root", default=None,
                        help="repo root (default: the package's parent)")
    parser.add_argument("--targets", default="ast,presets,protocol",
                        help="comma list: ast,presets,protocol "
                             "(default all three)")
    parser.add_argument("--baseline", default=None,
                        help="baseline file (default: "
                             "<root>/analyze_baseline_torch.json)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the presets target compiles (default "
                             "cuda; raises with no card)")
    parser.add_argument("--refresh-baseline", action="store_true",
                        help="rewrite the baseline from this run's "
                             "error findings and exit 0")
    parser.add_argument("--sarif", default=None, metavar="FILE",
                        help="write a SARIF 2.1.0 artifact")
    parser.add_argument("--json", default=None, metavar="FILE",
                        dest="json_out", help="write the full JSON report")
    parser.add_argument("--no-cache", action="store_true",
                        help="bypass the incremental result cache")
    parser.add_argument("--cache-dir", default=None,
                        help="cache directory (default: "
                             "<compile_cache_dir>/analyze)")
    parser.add_argument("--quiet", action="store_true")
    args = parser.parse_args(argv)

    if args.root is None:
        # the package's parent directory is the repo root in-tree; cwd
        # otherwise
        pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        root = os.path.dirname(pkg)
        if not os.path.isdir(os.path.join(root, "easydist_tpu_torch")):
            root = os.getcwd()
    else:
        root = os.path.abspath(args.root)
    baseline = args.baseline or os.path.join(root,
                                             "analyze_baseline_torch.json")
    targets = tuple(t.strip() for t in args.targets.split(",") if t.strip())

    from easydist_tpu_torch.analyze.driver import (export_sarif, run_driver,
                                             write_baseline)

    result = run_driver(root, targets=targets, baseline_path=baseline,
                        use_cache=not args.no_cache,
                        cache_dir=args.cache_dir, device=args.device)

    if args.refresh_baseline and not result.skipped:
        write_baseline(baseline, result.report.errors())
        if not args.quiet:
            print(f"baseline refreshed: {baseline} "
                  f"({len(result.report.errors())} error finding(s))")
        return 0

    if args.sarif:
        with open(args.sarif, "w", encoding="utf-8") as f:
            json.dump(export_sarif(result.report.findings), f, indent=1)
            f.write("\n")
    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as f:
            json.dump(result.to_json(), f, indent=1)
            f.write("\n")

    if not args.quiet:
        if result.skipped:
            print("analyze: skipped (EASYDIST_ANALYZE=0)")
        else:
            c = result.report.counts()
            print(f"analyze[{','.join(result.targets)}]: "
                  f"{c['error']} error(s) ({len(result.new_errors)} new, "
                  f"{result.baselined} baselined), {c['warning']} "
                  f"warning(s), {result.suppressed} suppressed; "
                  f"{result.n_files} file(s), cache {result.cache_hits} "
                  f"hit / {result.cache_misses} miss, "
                  f"{result.wall_s:.1f}s")
            for name, st in sorted(result.protocol.items()):
                print(f"  protocol[{name}]: {st['states']} states, "
                      f"{st['transitions']} transitions "
                      f"({'exhausted' if st['exhausted'] else 'CEILING'}"
                      f", committed {st['committed']})")
            for f_ in result.new_errors[:20]:
                print(f"  NEW {f_}")
            for f_ in result.report.findings:
                if f_.severity != "error":
                    print(f"  {f_}")
    return 1 if result.new_errors else 0


if __name__ == "__main__":
    sys.exit(main())
