"""fedlint CLI for the port: ``python -m fedml_tpu_torch.analysis``.

Exit codes: 0 = clean (or all findings baselined), 1 = new findings,
2 = usage error. ``--write-baseline`` regenerates the checked-in baseline
from the current findings (run it after deliberately accepting debt; the
diff review of the baseline file IS the acceptance step). A ``--select``
or ``--ignore`` naming a code of the reference's project-wide passes,
not ported yet (ROADMAP A16b (ii)), is a usage error.

The reference's ``--fix``/``--diff`` (its FL104 donation fixer) are not
flags here: torch has no buffer donation, so there is nothing to fix,
and argparse refuses them as usage errors.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from fedml_tpu_torch.analysis.linter import (RULES, apply_baseline,
                                             lint_paths,
                                             load_baseline, render_json,
                                             render_sarif, render_text,
                                             unported_codes, write_baseline)

# anchored to the installed package, not the cwd: the CLI must find the
# shipped baseline from any directory
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "fedlint_baseline.json")


def _split_codes(value):
    return {c.strip().upper() for c in value.split(",") if c.strip()}


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="fedlint",
        description="PyTorch/FL-aware static analysis for "
                    "fedml_tpu_torch (rule catalog: --list-rules)")
    parser.add_argument("paths", nargs="*", default=None,
                        help="files or directories to lint "
                             "(default: fedml_tpu_torch/)")
    parser.add_argument("--format", choices=("text", "json", "sarif"),
                        default="text",
                        help="text (human), json (the CI gate's report), "
                             "or sarif 2.1.0 (PR annotation upload)")
    parser.add_argument("--sarif-out", default=None, metavar="PATH",
                        help="also write the findings as SARIF 2.1.0 to "
                             "PATH (one lint run, two reports: a CI gate "
                             "keeps it next to its JSON report)")
    parser.add_argument("--baseline", default=DEFAULT_BASELINE,
                        help="baseline JSON tolerating pre-existing "
                             "findings (default: %(default)s; pass '' to "
                             "disable)")
    parser.add_argument("--write-baseline", action="store_true",
                        help="rewrite --baseline from the current findings "
                             "and exit 0")
    parser.add_argument("--select", type=_split_codes, default=None,
                        metavar="CODES", help="only these codes (comma-sep)")
    parser.add_argument("--ignore", type=_split_codes, default=None,
                        metavar="CODES", help="drop these codes (comma-sep)")
    parser.add_argument("--show-baselined", action="store_true",
                        help="text reporter: also print baselined findings")
    parser.add_argument("--max-seconds", type=float, default=None,
                        metavar="S",
                        help="wall-time budget for the whole run: exit "
                             "non-zero when it took longer (a CI gate "
                             "pins this so the project-wide passes "
                             "cannot silently regress lint latency as "
                             "the tree grows)")
    parser.add_argument("--list-rules", action="store_true")
    args = parser.parse_args(argv)
    t0 = time.monotonic()

    if args.list_rules:
        for code, (title, rationale) in sorted(RULES.items()):
            print(f"{code}: {title}\n    {rationale}")
        return 0

    unported = unported_codes(args.select, args.ignore)
    if unported:
        print(f"fedlint: {', '.join(unported)} belong to the project-wide "
              "passes not ported yet (ROADMAP A16b (ii))", file=sys.stderr)
        return 2

    paths = args.paths or ["fedml_tpu_torch"]
    try:
        findings = lint_paths(paths, select=args.select, ignore=args.ignore)
    except OSError as e:
        print(f"fedlint: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        if not args.baseline:
            print("fedlint: --write-baseline needs --baseline",
                  file=sys.stderr)
            return 2
        write_baseline(findings, args.baseline)
        print(f"fedlint: wrote {len(findings)} finding(s) to "
              f"{args.baseline}")
        return 0

    new = apply_baseline(findings, load_baseline(args.baseline))
    if args.sarif_out:
        with open(args.sarif_out, "w", encoding="utf-8") as fh:
            fh.write(render_sarif(findings))
            fh.write("\n")
    if args.format == "json":
        print(render_json(findings))
    elif args.format == "sarif":
        print(render_sarif(findings))
    else:
        print(render_text(findings, show_baselined=args.show_baselined))
    if _check_budget(args, t0):
        return 1
    return 1 if new else 0


def _check_budget(args, t0):
    """Enforce ``--max-seconds`` (0 = within budget / disabled, 1 =
    blown): the CI gate's guard against interprocedural passes silently
    regressing wall time as the tree grows."""
    if args.max_seconds is None:
        return 0
    elapsed = time.monotonic() - t0
    print(f"fedlint: wall time {elapsed:.1f}s "
          f"(budget {args.max_seconds:.1f}s)", file=sys.stderr)
    if elapsed > args.max_seconds:
        print("fedlint: wall-time budget exceeded -- an "
              "interprocedural pass regressed lint latency",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
