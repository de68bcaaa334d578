"""Per-iteration JSONL metrics sink (the training-side exposition).

One JSON object per line, flushed as written, so a tail/follow on the file
watches training live and a crashed run keeps every completed row.  Values
are coerced to plain Python scalars (numpy arrays and tensors fail ``json.dump``).
"""
from __future__ import annotations

import json
import threading


def _jsonable(v):
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    try:
        return float(v)          # numpy / torch scalars
    except (TypeError, ValueError):
        return str(v)


class JsonlSink:
    def __init__(self, path: str):
        self.path = str(path)
        self._lock = threading.Lock()
        self._f = open(self.path, "w")
        self.rows_written = 0

    def write(self, record: dict) -> None:
        line = json.dumps({k: _jsonable(v) for k, v in record.items()})
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()
            self.rows_written += 1

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class NullSink:
    """Free stand-in when no ``--metrics-out`` path was given."""

    path = None
    rows_written = 0

    def write(self, record: dict) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SINK = NullSink()
