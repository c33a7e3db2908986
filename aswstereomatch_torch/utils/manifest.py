"""Dataset-sweep manifest: checkpoint / resume / failure recovery.

A copy of ``aswstereomatch_tpu.utils.manifest`` (that package cannot be
imported without jax).  Stereo jobs are stateless per pair, so recovery is
re-dispatch of unfinished pairs: the checkpoint is a JSON manifest of
completed pair ids plus their per-pair metric records.  A sweep killed at
any point resumes from the manifest.

The manifest is written atomically (tmp + rename) after every flush so a
crash can lose at most the in-flight batch.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Iterable, List, Optional


class SweepManifest:
    def __init__(self, path: str, config_hash: str):
        self.path = path
        self.config_hash = config_hash
        self._state = {"config_hash": config_hash, "done": {}}
        if os.path.exists(path):
            with open(path) as f:
                prev = json.load(f)
            if prev.get("config_hash") == config_hash:
                self._state = prev
            # different config: start fresh (the old file is overwritten on
            # first flush; results for another config must not be resumed)

    @property
    def done_ids(self) -> set:
        return set(self._state["done"])

    def pending(self, pair_ids: Iterable[str]) -> List[str]:
        done = self.done_ids
        return [p for p in pair_ids if p not in done]

    def record(self, pair_id: str, result: Optional[Dict] = None) -> None:
        self._state["done"][pair_id] = result or {}

    def flush(self) -> None:
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self._state, f)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def results(self) -> Dict[str, Dict]:
        return dict(self._state["done"])


def run_sweep(
    pair_ids: List[str],
    process_fn,
    manifest_path: str,
    config_hash: str,
    batch_size: int = 1,
    flush_every: int = 1,
    pass_next: "bool | int" = False,
):
    """Run process_fn(pair_id) -> dict over all pairs with resume.

    Returns the full results dict.  ``process_fn`` failures propagate after
    the manifest is flushed, so completed work is never lost.

    With ``pass_next`` truthy the callback is invoked as
    ``process_fn(pid, next_pids=<tuple of the next int(pass_next) pending
    ids>)`` so it can keep a submit-ahead queue of device work that deep
    before blocking on the current pair (software pipelining: overlaps
    host IO and launch latency with compute; ``True`` means depth 1).
    """
    m = SweepManifest(manifest_path, config_hash)
    todo = m.pending(pair_ids)
    since_flush = 0
    try:
        for i, pid in enumerate(todo):
            if pass_next:
                # Window of upcoming ids (pass_next=True -> 1, an int ->
                # that many): the callback keeps a submit-ahead queue of
                # device work this deep, so host decode/encode overlaps
                # device compute.
                depth = int(pass_next)
                rec = process_fn(pid, next_pids=todo[i + 1 : i + 1 + depth])
            else:
                rec = process_fn(pid)
            m.record(pid, rec)
            since_flush += 1
            if since_flush >= flush_every:
                m.flush()
                since_flush = 0
    finally:
        m.flush()
    return m.results()
