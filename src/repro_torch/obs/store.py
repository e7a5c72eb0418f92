"""The embedded experiment store: indexed SQLite over measured cells — the
port's copy of ``repro/obs/store.py``, with the same schema, so a store
written by either package is read by the other.

Schema (single file, stdlib ``sqlite3``, no dependencies):

* ``runs``    — one row per measuring process: timestamp, git SHA,
  ENGINE_REV, backend (the port records ``cuda`` or ``cpu``), mode,
  free-form note.
* ``cells``   — one row per measured cell: (bench, lane_key) names the
  measurement, ``statics_key`` fingerprints the program statics (a lane
  only compares against history of the SAME program family), cold/warm
  walls with the full min-of-N wall list, and the lane's runtime params
  as JSON.
* ``metrics`` — named scalars per cell with a ``direction``:
  ``+1`` higher-is-better (gated), ``-1`` lower-is-better (gated),
  ``0`` informational.

Indexed on ``(bench, engine_rev, statics_key, lane_key)`` plus ``run_id``
for per-run scans.  Writes are append-only: nothing ever UPDATEs or
DELETEs a row, so the history a gate reads is immutable.
"""
from __future__ import annotations

import json
import os
import sqlite3
import subprocess
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

_SCHEMA = """
CREATE TABLE IF NOT EXISTS runs (
  run_id     INTEGER PRIMARY KEY AUTOINCREMENT,
  ts         REAL NOT NULL,
  git_sha    TEXT,
  engine_rev TEXT,
  backend    TEXT,
  mode       TEXT,
  note       TEXT
);
CREATE TABLE IF NOT EXISTS cells (
  cell_id     INTEGER PRIMARY KEY AUTOINCREMENT,
  run_id      INTEGER NOT NULL REFERENCES runs(run_id),
  bench       TEXT NOT NULL,
  lane_key    TEXT NOT NULL,
  statics_key TEXT NOT NULL DEFAULT '',
  engine_rev  TEXT,
  git_sha     TEXT,
  ts          REAL NOT NULL,
  wall_cold_s REAL,
  wall_warm_s REAL,
  warm_n      INTEGER,
  warm_walls  TEXT,
  lane_params TEXT
);
CREATE TABLE IF NOT EXISTS metrics (
  cell_id   INTEGER NOT NULL REFERENCES cells(cell_id),
  name      TEXT NOT NULL,
  value     REAL,
  direction INTEGER NOT NULL DEFAULT 0,
  PRIMARY KEY (cell_id, name)
);
CREATE INDEX IF NOT EXISTS idx_cells_key
  ON cells(bench, engine_rev, statics_key, lane_key);
CREATE INDEX IF NOT EXISTS idx_cells_run ON cells(run_id);
"""

MetricValue = Union[float, Tuple[float, int]]


def default_backend() -> str:
    """The backend a run records: ``cuda`` when a card is present, else
    ``cpu``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def git_sha(root: Optional[str] = None) -> str:
    """Current commit SHA (short), or "unknown" outside a git checkout."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
            cwd=root or os.path.dirname(os.path.abspath(__file__)))
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else "unknown"
    except OSError:
        return "unknown"


class ExperimentStore:
    """Append-only indexed store over one SQLite file."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._conn = sqlite3.connect(path)
        self._conn.row_factory = sqlite3.Row
        self._conn.executescript(_SCHEMA)
        self._conn.commit()

    def close(self) -> None:
        self._conn.close()

    # -- writes (append-only) ---------------------------------------------

    def begin_run(self, engine_rev: str = "",
                  backend: Optional[str] = None, mode: str = "",
                  note: str = "", sha: Optional[str] = None) -> int:
        """A new run's id; ``backend`` defaults to :func:`default_backend`."""
        cur = self._conn.execute(
            "INSERT INTO runs (ts, git_sha, engine_rev, backend, mode, note)"
            " VALUES (?, ?, ?, ?, ?, ?)",
            (time.time(), sha if sha is not None else git_sha(),
             engine_rev, default_backend() if backend is None else backend,
             mode, note))
        self._conn.commit()
        return int(cur.lastrowid)

    def record_cell(self, run_id: int, bench: str, lane_key: str, *,
                    statics_key: str = "",
                    wall_cold_s: Optional[float] = None,
                    wall_warm_s: Optional[float] = None,
                    warm_walls: Optional[Sequence[float]] = None,
                    lane_params: Optional[Dict[str, Any]] = None,
                    metrics: Optional[Dict[str, MetricValue]] = None) -> int:
        """One measured cell.  ``warm_walls`` is the full min-of-N list (the
        regression gate's samples); ``wall_warm_s`` defaults to its min.
        ``metrics`` values are either a bare float (informational) or a
        ``(value, direction)`` pair (+1 higher-better / -1 lower-better
        marks the metric GATED for ``tools/bench_regress.py``)."""
        row = self._conn.execute(
            "SELECT git_sha, engine_rev FROM runs WHERE run_id = ?",
            (run_id,)).fetchone()
        if row is None:
            raise ValueError(f"unknown run_id {run_id}")
        if wall_warm_s is None and warm_walls:
            wall_warm_s = min(warm_walls)
        cur = self._conn.execute(
            "INSERT INTO cells (run_id, bench, lane_key, statics_key,"
            " engine_rev, git_sha, ts, wall_cold_s, wall_warm_s, warm_n,"
            " warm_walls, lane_params)"
            " VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (run_id, bench, lane_key, statics_key, row["engine_rev"],
             row["git_sha"], time.time(), wall_cold_s, wall_warm_s,
             len(warm_walls) if warm_walls else None,
             json.dumps([float(w) for w in warm_walls]) if warm_walls
             else None,
             json.dumps(lane_params) if lane_params else None))
        cell_id = int(cur.lastrowid)
        for name, v in (metrics or {}).items():
            value, direction = v if isinstance(v, tuple) else (v, 0)
            self._conn.execute(
                "INSERT INTO metrics (cell_id, name, value, direction)"
                " VALUES (?, ?, ?, ?)",
                (cell_id, name, None if value is None else float(value),
                 int(direction)))
        self._conn.commit()
        return cell_id

    # -- queries ----------------------------------------------------------

    @staticmethod
    def _cell_dict(row: sqlite3.Row) -> Dict[str, Any]:
        d = dict(row)
        d["warm_walls"] = (json.loads(d["warm_walls"])
                           if d.get("warm_walls") else [])
        d["lane_params"] = (json.loads(d["lane_params"])
                            if d.get("lane_params") else {})
        return d

    def _attach_metrics(self, cells: List[Dict[str, Any]]) -> None:
        for c in cells:
            c["metrics"] = {
                r["name"]: {"value": r["value"],
                            "direction": r["direction"]}
                for r in self._conn.execute(
                    "SELECT name, value, direction FROM metrics"
                    " WHERE cell_id = ?", (c["cell_id"],))}

    def latest_run_id(self) -> Optional[int]:
        row = self._conn.execute("SELECT MAX(run_id) m FROM runs").fetchone()
        return int(row["m"]) if row and row["m"] is not None else None

    def run_ids(self) -> List[int]:
        return [int(r["run_id"]) for r in self._conn.execute(
            "SELECT run_id FROM runs ORDER BY run_id")]

    def cells_of_run(self, run_id: int) -> List[Dict[str, Any]]:
        cells = [self._cell_dict(r) for r in self._conn.execute(
            "SELECT * FROM cells WHERE run_id = ? ORDER BY cell_id",
            (run_id,))]
        self._attach_metrics(cells)
        return cells

    def history(self, bench: str, lane_key: str, *,
                engine_rev: Optional[str] = None,
                statics_key: Optional[str] = None,
                before_run: Optional[int] = None) -> List[Dict[str, Any]]:
        """Every recorded cell of (bench, lane_key), oldest first — the
        indexed lookup the regression gate and trajectory queries use.
        ``engine_rev``/``statics_key`` restrict to one program family;
        ``before_run`` excludes the current run (gate = history vs now)."""
        q = ("SELECT * FROM cells WHERE bench = ? AND lane_key = ?")
        args: List[Any] = [bench, lane_key]
        if engine_rev is not None:
            q += " AND engine_rev = ?"
            args.append(engine_rev)
        if statics_key is not None:
            q += " AND statics_key = ?"
            args.append(statics_key)
        if before_run is not None:
            q += " AND run_id < ?"
            args.append(before_run)
        q += " ORDER BY run_id, cell_id"
        cells = [self._cell_dict(r) for r in self._conn.execute(q, args)]
        self._attach_metrics(cells)
        return cells

    def metric_history(self, bench: str, lane_key: str, metric: str, *,
                       engine_rev: Optional[str] = None
                       ) -> List[Tuple[int, float]]:
        """``[(run_id, value), ...]`` oldest-first — e.g. the AUC or
        warm-wall trajectory across stored runs for one lane."""
        out = []
        for c in self.history(bench, lane_key, engine_rev=engine_rev):
            if metric == "wall_warm_s":
                v = c.get("wall_warm_s")
            else:
                m = c["metrics"].get(metric)
                v = m["value"] if m else None
            if v is not None:
                out.append((int(c["run_id"]), float(v)))
        return out

    def metric_trajectory(self, bench: str, lane_key: str, metric: str
                          ) -> List[Tuple[int, str, float]]:
        """``[(run_id, engine_rev, value), ...]`` oldest-first ACROSS engine
        revisions — the "AUC trajectory across ENGINE_REV" report (ROADMAP):
        unlike :meth:`metric_history` (which restricts to one rev so the
        regression gate compares like with like), this deliberately spans
        every rev so a metric can be followed through engine rewrites —
        each point is labelled with the rev that produced it, because a
        jump at a rev boundary is an engine change, not a regression."""
        out = []
        for c in self.history(bench, lane_key):
            if metric == "wall_warm_s":
                v = c.get("wall_warm_s")
            else:
                m = c["metrics"].get(metric)
                v = m["value"] if m else None
            if v is not None:
                out.append((int(c["run_id"]), c.get("engine_rev") or "",
                            float(v)))
        return out

    def trajectory_report(self, bench: str, metric: str) -> str:
        """Human-readable ``metric_trajectory`` over every lane of a bench
        (the reference's ``tools/metric_trajectory.py`` CLI reads the same
        file): one block per lane, one line
        per stored run, engine-rev labelled, with the delta vs the
        previous point."""
        lines = [f"== {bench}: {metric} trajectory across ENGINE_REV =="]
        for _, lane in self.lanes(bench):
            traj = self.metric_trajectory(bench, lane, metric)
            if not traj:
                continue
            lines.append(f"  {lane}:")
            prev = None
            for run_id, rev, v in traj:
                delta = "" if prev is None else f"  ({v - prev:+.4f})"
                lines.append(f"    run {run_id:>4d} [{rev or '?':>10s}]"
                             f"  {v:.4f}{delta}")
                prev = v
        if len(lines) == 1:
            lines.append(f"  (no stored cells carry metric {metric!r})")
        return "\n".join(lines)

    def lanes(self, bench: Optional[str] = None) -> List[Tuple[str, str]]:
        """Distinct (bench, lane_key) pairs recorded so far."""
        q = "SELECT DISTINCT bench, lane_key FROM cells"
        args: List[Any] = []
        if bench is not None:
            q += " WHERE bench = ?"
            args.append(bench)
        q += " ORDER BY bench, lane_key"
        return [(r["bench"], r["lane_key"])
                for r in self._conn.execute(q, args)]

    def query_plan_uses_index(self) -> bool:
        """True when the history lookup is answered via ``idx_cells_key``
        (tests assert the index actually serves the hot query)."""
        plan = self._conn.execute(
            "EXPLAIN QUERY PLAN SELECT * FROM cells WHERE bench = ?"
            " AND engine_rev = ? AND statics_key = ? AND lane_key = ?",
            ("b", "e", "s", "l")).fetchall()
        return any("idx_cells_key" in (r["detail"] or "") for r in plan)


def default_store_path() -> str:
    """``REPRO_STORE`` env override, else
    ``benchmarks/artifacts/experiments.sqlite`` at the repo root."""
    env = os.environ.get("REPRO_STORE")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    return os.path.join(root, "benchmarks", "artifacts",
                        "experiments.sqlite")


_DEFAULT: Optional[ExperimentStore] = None


def default_store() -> ExperimentStore:
    """The process-wide store at :func:`default_store_path` (opened once;
    re-opened if ``REPRO_STORE`` now points elsewhere)."""
    global _DEFAULT
    path = default_store_path()
    if _DEFAULT is None or _DEFAULT.path != path:
        _DEFAULT = ExperimentStore(path)
    return _DEFAULT
