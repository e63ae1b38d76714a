"""Inspect an obs metrics snapshot: selection heatmap + metric tables (port
of the JAX package's ``launch/inspect.py``).

  PYTHONPATH=src python -m repro_torch.launch.inspect metrics.json

Reads the JSON written by ``--metrics-json`` on the train/serve launchers
(the ``obs.snapshot()`` document: ``{subsystem: {metric: value}}`` plus an
optional ``selection`` key) and renders:

  * the per-block selection-frequency heatmap over training — columns are
    step windows, shade is the in-window selection rate, the bottom row is
    normalized selection entropy. A falling entropy profile is the
    exploration->exploitation transition the paper's epsilon-decay predicts;
    flat entropy means a schedule/uniform policy (lisa, random).
  * a flat table of every counter/gauge/histogram summary in the snapshot.

``--bins`` controls heatmap resolution; ``--no-metrics`` / ``--no-heatmap``
restrict output to one view.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("snapshot", help="metrics JSON written by --metrics-json")
    ap.add_argument("--bins", type=int, default=12,
                    help="heatmap step-window count")
    ap.add_argument("--no-metrics", action="store_true",
                    help="skip the metric tables")
    ap.add_argument("--no-heatmap", action="store_true",
                    help="skip the selection heatmap")
    args = ap.parse_args(argv)

    from repro_torch.obs import report
    from repro_torch.obs.selection import SelectionTrace

    with open(args.snapshot) as f:
        doc = json.load(f)

    sel_doc = doc.pop("selection", None)
    if not args.no_heatmap:
        if sel_doc:
            trace = SelectionTrace.from_snapshot(sel_doc)
            print(report.render_selection_trace(trace, bins=args.bins))
        else:
            print("no selection telemetry in snapshot (train with "
                  "--metrics-json and an obs-enabled run to record it)")
    if not args.no_metrics:
        if not args.no_heatmap:
            print()
        print(report.render_metrics(doc))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
