"""Persistent op-performance cache (reference: easydist/utils/
graph_profile_db.py:24-48 — pickle at ~/.easydist/perf.db)."""

from __future__ import annotations

import copy
import os
import pickle
import threading
from typing import Any, Dict, Optional

from easydist_tpu_torch import config as edconfig


class PerfDB:

    def __init__(self, path: Optional[str] = None):
        self.path = path or edconfig.prof_db_path
        self._lock = threading.RLock()
        self._db = {}
        if os.path.exists(self.path):
            try:
                with open(self.path, "rb") as f:
                    self._db = pickle.load(f)
            except Exception:
                self._db = {}

    def get_op_perf(self, key: str, sub_key: str) -> Optional[Any]:
        with self._lock:
            return self._db.get(key, {}).get(sub_key)

    def record_op_perf(self, key: str, sub_key: str, value: Any) -> None:
        with self._lock:
            self._db.setdefault(key, {})[sub_key] = value

    def append_history(self, key: str, sub_key: str, entry: Any,
                       cap: int = 32) -> None:
        """Append `entry` to a bounded history list under (key, sub_key) —
        the shape serving metrics and fleet gauges use, so N writers keep
        rolling windows instead of clobbering one value."""
        with self._lock:
            hist = self._db.get(key, {}).get(sub_key) or []
            self._db.setdefault(key, {})[sub_key] = \
                (list(hist) + [entry])[-cap:]

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Read-only export of the whole store as a deep-copied plain dict
        ({key: {sub_key: value}}).  The consumer owns the copy — mutating
        it never touches the live store, and concurrent writers (serving
        metrics exporters, calibration) never tear a read mid-walk.  This
        is how the simulator/planner consume calibration and metrics
        without reaching into `_db` or re-reading the pickle path."""
        with self._lock:
            return copy.deepcopy(self._db)

    def source_mtime(self) -> Optional[float]:
        """mtime of the backing pickle, or None when it does not exist —
        the cache-invalidation key callers use instead of re-deriving the
        path from config themselves."""
        return db_mtime(self.path)

    def persist(self) -> None:
        with self._lock:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            with open(self.path, "wb") as f:
                pickle.dump(self._db, f)

    def __len__(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._db.values())


def discovery_db_path() -> str:
    """Side-car pickle for discovery telemetry.  Kept separate from the
    op-perf DB on purpose: the discovery rule cache's salt includes the
    op-perf DB mtime (composite rule prices embed measured op times), so
    writing per-compile telemetry into that file would invalidate the
    rule cache on every compile."""
    return edconfig.prof_db_path + ".discovery"


def record_discovery(counters: Dict[str, Any],
                     db: Optional[PerfDB] = None) -> None:
    """Export one trace's discovery counters (probes_compiled,
    rules_from_cache, rules_from_group, discovery_seconds, ...) into the
    rolling "discovery"/"traces" history so dashboards and bench scenarios
    read the same numbers the compile log printed.  Best-effort: a
    read-only DB path must never fail a compile."""
    try:
        db = db or PerfDB(discovery_db_path())
        db.append_history("discovery", "traces", dict(counters))
        db.persist()
    except Exception:
        pass


def db_mtime(path: Optional[str] = None) -> Optional[float]:
    """mtime of the (default) PerfDB pickle without loading it — the
    cheap staleness probe cache invalidators key on (autoflow.solver's
    op-time cache)."""
    try:
        return os.path.getmtime(path or edconfig.prof_db_path)
    except OSError:
        return None
