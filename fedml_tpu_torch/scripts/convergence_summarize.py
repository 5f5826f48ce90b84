"""Build (or rebuild) the convergence ``summary.json`` from the curves
(counterpart of ``scripts/convergence_summarize.py``).

``fedml_tpu_torch.scripts.convergence`` writes ``summary.json`` only
when every config of one invocation finishes; a killed run leaves
curves but no summary. This tool derives the summary from whatever
``*.jsonl`` curves an outdir holds -- the plateau (mean train accuracy
over the last ``--tail`` rounds of each curve), the spread across
configs and the agreement verdict -- labelled with each curve's round
count. It reads files only, on no device.

Usage: python -m fedml_tpu_torch.scripts.convergence_summarize
       [--outdir DIR] [--tail 10] [--tol 0.03] [--min_rounds 100]
Exit 0 = all present configs agree AND each has >= --min_rounds rounds;
exit 1 otherwise (summary.json is written either way).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def _mode(name):
    for mode in ("lanes3", "lanes", "flat"):
        if name.endswith(mode):
            return mode
    return "?"


def summarize(outdir, tail, tol, min_rounds):
    results = []
    for path in sorted(glob.glob(os.path.join(outdir, "*.jsonl"))):
        name = os.path.splitext(os.path.basename(path))[0]
        curve = []
        with open(path) as f:
            for ln in f:
                if not ln.strip():
                    continue
                try:
                    curve.append(json.loads(ln))
                except json.JSONDecodeError:
                    # a killed run can leave a truncated final line
                    print(f"# dropping unparseable line in {path}",
                          file=sys.stderr)
                    break
        if not curve:
            continue
        accs = [c["train_acc"] for c in curve[-tail:]]
        results.append({
            "name": name,
            "dtype": "bf16" if name.startswith("bf16") else "fp32",
            "mode": _mode(name), "rounds": len(curve),
            "complete": len(curve) >= min_rounds,
            "plateau_acc": sum(accs) / len(accs),
            "final_loss": curve[-1]["train_loss"]})
    if not results:
        raise SystemExit(f"no curves in {outdir}")
    accs = [r["plateau_acc"] for r in results]
    spread = max(accs) - min(accs)
    summary = {
        "results": results, "plateau_spread": round(spread, 4), "tol": tol,
        "tail": tail, "min_rounds": min_rounds, "agree": spread <= tol,
        "all_complete": all(r["complete"] for r in results),
        "note": ("derived by convergence_summarize from the curves; "
                 "'complete' is per-curve >= min_rounds")}
    with open(os.path.join(outdir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def main(argv=None):
    p = argparse.ArgumentParser("convergence_summarize")
    p.add_argument("--outdir", default="bench_results/convergence_cpu")
    p.add_argument("--tail", type=int, default=10)
    p.add_argument("--tol", type=float, default=0.03)
    p.add_argument("--min_rounds", type=int, default=100)
    args = p.parse_args(argv)
    s = summarize(args.outdir, args.tail, args.tol, args.min_rounds)
    for r in s["results"]:
        print(f"{r['name']:>11}: rounds={r['rounds']:<4} "
              f"plateau_acc={r['plateau_acc']:.4f} "
              f"final_loss={r['final_loss']:.4f} "
              f"{'' if r['complete'] else '(INCOMPLETE)'}")
    print(f"plateau spread {s['plateau_spread']:.4f} (tol {s['tol']}): "
          f"{'AGREE' if s['agree'] else 'DIVERGED'}; "
          f"all_complete={s['all_complete']}")
    return s


if __name__ == "__main__":
    out = main()
    sys.exit(0 if (out["agree"] and out["all_complete"]) else 1)
