"""Progress reporters for Tune runs.

The port's copy of ``ray_tpu/tune/reporter.py``.
Reference parity: tune/progress_reporter.py (CLIReporter /
JupyterNotebookReporter) — the periodic trial-status table printed while
an experiment runs, with configurable metric columns and a report-rate
cap. Wired through ``RunConfig(progress_reporter=...)``; the Tuner's
result loop calls ``on_result``/``on_trial_complete`` and the reporter
decides when to print.
"""
from __future__ import annotations

import sys
import time
from typing import Optional


class CLIReporter:
    """Prints a trial table at most every ``max_report_frequency``
    seconds plus a final summary (reference: CLIReporter defaults)."""

    def __init__(self, metric_columns: Optional[list[str]] = None,
                 max_report_frequency: float = 5.0,
                 max_progress_rows: int = 20, out=None):
        self.metric_columns = list(metric_columns or [])
        self.max_report_frequency = max_report_frequency
        self.max_progress_rows = max_progress_rows
        self._out = out or sys.stdout
        self._last = 0.0
        self._rows: dict[int, dict] = {}     # trial index -> latest row
        self._status: dict[int, str] = {}
        self._printed_final = False

    # -- hooks the Tuner loop calls --------------------------------------

    def setup(self, metric: Optional[str]) -> None:
        if metric and metric not in self.metric_columns:
            self.metric_columns.append(metric)

    def on_result(self, index: int, config: dict, result: dict,
                  status: str) -> None:
        self._rows[index] = {"config": config, "result": result}
        self._status[index] = status
        now = time.monotonic()
        if now - self._last >= self.max_report_frequency:
            self._last = now
            self._print_table()

    def on_trial_complete(self, index: int, status: str) -> None:
        self._status[index] = status

    def final(self) -> None:
        if not self._printed_final:
            self._printed_final = True
            self._print_table(header="== trial results ==")

    # -- rendering --------------------------------------------------------

    def _print_table(self, header: str = "== trial progress ==") -> None:
        cols = self.metric_columns
        w = self._out
        lines = [header]
        shown = sorted(self._rows)[: self.max_progress_rows]
        name_w = max([len(f"trial_{i}") for i in shown] or [8])
        head = (f"{'trial':<{name_w}}  {'status':<10} "
                + " ".join(f"{c:>14}" for c in cols))
        lines.append(head)
        for i in shown:
            r = self._rows[i]["result"]
            vals = []
            for c in cols:
                v = r.get(c)
                vals.append(f"{v:>14.5g}" if isinstance(v, (int, float))
                            else f"{str(v):>14}")
            lines.append(f"{f'trial_{i}':<{name_w}}  "
                         f"{self._status.get(i, ''):<10} "
                         + " ".join(vals))
        hidden = len(self._rows) - len(shown)
        if hidden > 0:
            lines.append(f"... and {hidden} more trials")
        print("\n".join(lines), file=w, flush=True)
