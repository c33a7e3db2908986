"""RSS-sampling wrapper for long soaks.

The counterpart of the repository's ``tools/soak_runner.py``.  It launches
a child command, samples the child's resident set (VmRSS) every
``--interval`` seconds for the child's whole life, and writes the curve and
its summary to a JSON record; it exits with the child's return code.  Used
around a long sweep (``python -m aswstereomatch_torch.tools.sweep``), where
the claim under test is that host memory stays bounded over many pairs.
``rss_mb`` is also the VmRSS reader of ``serve_soak``.  The record carries
the card's ``nvidia-smi`` line where there is one; which device the child
uses is the child's own argument.

    python -m aswstereomatch_torch.tools.soak_runner --out results_torch/x.json \\
        [--interval 3] [--log child.log] -- cmd args...
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from .common import card_line, stop


def rss_mb(pid: int) -> float | None:
    """The resident set of process ``pid`` in MiB, None once it is gone."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        return None
    return None


def run(cmd: list, out: str, interval: float = 3.0, log: str | None = None,
        env: dict | None = None, timeout_s: float | None = None) -> dict:
    """Run ``cmd`` to its end (killed past ``timeout_s``, where given),
    sampling its RSS; write and return the record."""
    logf = open(log, "w") if log else None
    t0 = time.time()
    samples = []
    child = None
    try:
        child = subprocess.Popen(cmd, stdout=logf or None,
                                 stderr=subprocess.STDOUT if logf else None, env=env)
        while child.poll() is None:
            if timeout_s is not None and time.time() - t0 > timeout_s:
                break
            m = rss_mb(child.pid)
            if m:  # 0 while the child's memory is torn down at its exit
                samples.append([round(time.time() - t0, 1), round(m, 1)])
            time.sleep(interval)
    finally:
        timed_out = child is not None and child.poll() is None
        if child is not None:
            stop(child)
        if logf:
            logf.close()
    rss_vals = [m for _, m in samples]
    rec = {
        "cmd": cmd,
        "returncode": child.returncode,
        "wall_s": round(time.time() - t0, 1),
        "rss_mb_first": rss_vals[0] if rss_vals else None,
        "rss_mb_peak": max(rss_vals) if rss_vals else None,
        "rss_mb_last": rss_vals[-1] if rss_vals else None,
        "samples": len(samples),
        "interval_s": interval,
        "rss_curve": samples,
        "timed_out": timed_out,
        "card": card_line(),
    }
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True)
    ap.add_argument("--interval", type=float, default=3.0)
    ap.add_argument("--log", default=None, help="child stdout/stderr file (default: inherit)")
    ap.add_argument("cmd", nargs=argparse.REMAINDER, help="-- child command")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        print("no child command given", file=sys.stderr)
        return 2
    rec = run(cmd, args.out, args.interval, args.log)
    print(json.dumps({k: rec[k] for k in ("returncode", "wall_s", "rss_mb_first",
                                          "rss_mb_peak", "rss_mb_last")}))
    return rec["returncode"]


if __name__ == "__main__":
    sys.exit(main())
