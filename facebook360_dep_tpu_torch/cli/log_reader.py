"""Pipeline log reader: live progress + metric extraction from stage logs.

Reference: ``scripts/ui/log_reader.py`` tails glog files and the UI parses
progress and quality metrics out of them — logs are the metrics transport
(SURVEY §5.5; e.g. test_derp_cli.py:40-61 parses
``ComputeRephotographyErrors.INFO``). Headless equivalent: follow one or
more log files (or a directory of them), extract the known metric patterns,
and emit a JSON summary on exit (or periodically with --follow).
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import re
import sys
import time

log = logging.getLogger("log_reader")

# (name, regex with one float group) — the reference's log contracts
METRIC_PATTERNS = [
    ("rephoto_mssim_r", re.compile(r"TOTAL average MSSIM.*?R\s*([\d.]+)")),
    ("rephoto_mssim_g", re.compile(r"TOTAL average MSSIM.*?G\s*([\d.]+)")),
    ("rephoto_mssim_b", re.compile(r"TOTAL average MSSIM.*?B\s*([\d.]+)")),
    ("total_rephoto_error", re.compile(r"total[_ ]rephoto[_ ]error[:=\s]+([\d.]+)")),
    ("median_reprojection_error_px", re.compile(r"median reprojection error[:\s]+([\d.]+)")),
    ("elapsed_s", re.compile(r"-- Elapsed time[:\s]+([\d.]+)s")),
    ("total_s", re.compile(r"-- TOTAL[:\s]+([\d.]+)s")),
    ("pingpong_changed_pct", re.compile(r"ping[- ]pong.*?([\d.]+)\s*% changed")),
    ("level_seconds", re.compile(r"level \d+ \(\d+x\d+\)[:\s]+([\d.]+)s")),
]
PROGRESS_PATTERN = re.compile(r"frame (\d+) level (\d+)")


def scan_line(line: str, metrics: dict, progress: dict) -> None:
    for name, pat in METRIC_PATTERNS:
        m = pat.search(line)
        if m:
            metrics.setdefault(name, []).append(float(m.group(1)))
    m = PROGRESS_PATTERN.search(line)
    if m:
        progress["frame"] = m.group(1)
        progress["level"] = int(m.group(2))


def follow(paths, poll_s: float = 1.0, once: bool = False):
    """Generator of new lines across all files (tail -f semantics)."""
    offsets = {}
    while True:
        emitted = False
        for path in paths:
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            pos = offsets.get(path, 0)
            if size > pos:
                with open(path, errors="replace") as f:
                    f.seek(pos)
                    for line in f:
                        yield path, line
                        emitted = True
                    offsets[path] = f.tell()
        if once:
            return
        if not emitted:
            time.sleep(poll_s)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--logs", required=True, help="log file, glob, or directory")
    p.add_argument("--follow", action="store_true", help="keep tailing (ctrl-c to stop)")
    p.add_argument("--json_out", default="", help="write the metric summary as JSON")
    args = p.parse_args(argv)

    if os.path.isdir(args.logs):
        paths = sorted(glob.glob(os.path.join(args.logs, "*")))
    else:
        paths = sorted(glob.glob(args.logs)) or [args.logs]

    metrics: dict = {}
    progress: dict = {}
    try:
        for path, line in follow(paths, once=not args.follow):
            scan_line(line, metrics, progress)
            if args.follow:
                sys.stdout.write(line)
    except KeyboardInterrupt:
        pass

    summary = {
        "progress": progress,
        "metrics": {k: {"last": v[-1], "count": len(v)} for k, v in metrics.items()},
    }
    log.info("%s", json.dumps(summary, indent=2))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
