"""Study/experiment report: summarize a tracking store from the CLI (port of
``qat_vit_tpu/tracking/report.py``; either package's store)::

    python -m qat_vit_tpu_torch.tracking.report sqlite:///mlflow.db clue-vit-qat-final
"""

from __future__ import annotations

import argparse
from typing import Optional

from qat_vit_tpu_torch.tracking.tracker import SqliteTracker


def summarize(uri: str, experiment: str) -> dict:
    # create=False: summarizing is a read; a misspelled experiment must
    # error with the known names, not be silently created in the store
    t = SqliteTracker(uri, experiment, create=False)
    runs = t.runs()
    out = {"experiment": experiment, "n_runs": len(runs), "runs": []}
    with t._conn() as c:
        for r in runs:
            row = c.execute(
                "SELECT start_time, end_time FROM runs WHERE run_uuid=?",
                (r["run_id"],),
            ).fetchone()
            dur = (row[1] - row[0]) / 1000.0 if row and row[0] and row[1] else None
            metrics = t.metrics(r["run_id"])
            by_key: dict = {}
            for m in metrics:
                by_key.setdefault(m["key"], []).append((m["step"], m["value"]))
            last = {k: sorted(v)[-1][1] for k, v in by_key.items()}
            best_val = max(
                (v for _, v in by_key.get("val_acc_limited", [])), default=None
            )
            out["runs"].append(
                {
                    "name": r["name"], "status": r["status"],
                    "duration_s": dur, "last_metrics": last,
                    "best_val_acc_limited": best_val,
                    "params": t.params(r["run_id"]),
                }
            )
    vals = [r["best_val_acc_limited"] for r in out["runs"]
            if r["best_val_acc_limited"] is not None]
    out["best_val_acc_limited_overall"] = max(vals) if vals else None
    return out


def format_report(s: dict) -> str:
    lines = [
        f"experiment: {s['experiment']}  runs: {s['n_runs']}"
        + (f"  best val_acc_limited: {s['best_val_acc_limited_overall']:.4f}"
           if s["best_val_acc_limited_overall"] is not None else ""),
        f"{'run':<22} {'status':<9} {'dur(s)':>7} {'best_acc':>9} {'last train_loss':>16}",
        "-" * 70,
    ]
    for r in s["runs"]:
        dur = f"{r['duration_s']:.0f}" if r["duration_s"] is not None else "-"
        acc = (f"{r['best_val_acc_limited']:.4f}"
               if r["best_val_acc_limited"] is not None else "-")
        loss = r["last_metrics"].get("train_loss")
        loss = f"{loss:.4f}" if loss is not None else "-"
        name = r["name"] or "-"  # unnamed runs store NULL
        status = r["status"] or "-"
        lines.append(f"{name:<22} {status:<9} {dur:>7} {acc:>9} {loss:>16}")
    return "\n".join(lines)


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser(description="summarize a tracking store")
    p.add_argument("uri", help="e.g. sqlite:///mlflow.db")
    p.add_argument("experiment")
    args = p.parse_args(argv)
    print(format_report(summarize(args.uri, args.experiment)))


if __name__ == "__main__":  # pragma: no cover
    main()
