"""JSONL sink: one line-atomic append per record, crash-safe (the port's
copy of ``magiattention_tpu/telemetry/export.py``).

Records are plain JSON objects; numpy scalars/arrays are converted on the
way out so call sites can pass solver/planner arrays without ceremony.
The file opens lazily on the first record, so merely enabling telemetry
does not create files in processes that never plan or step.

Multi-writer safety: the file is opened with ``O_APPEND`` and each record
is emitted as a single ``os.write`` of one ``\\n``-terminated line, so
concurrent writers to the same file (threads, or processes that happen to
share a path on a network filesystem) never interleave partial records.
On top of that, :func:`process_unique_path` gives each writer its own
file — ``<prefix>-<host>-<pid>-<token>.jsonl`` — so two hosts of a
multi-slice job with colliding pids still never share a file.
"""

from __future__ import annotations

import json
import os
import socket
import uuid
from typing import Any

import numpy as np
import torch


# JSON's own scalars (numpy's float64 is a float: json writes it as one)
_PLAIN = (str, int, float, bool, type(None))


def _jsonable(x: Any) -> Any:
    """Best-effort conversion to JSON-serializable builtins (scalars tested
    first: a record is mostly scalars, and this runs on every step's)."""
    if isinstance(x, _PLAIN):
        return x
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, torch.Tensor):
        return x.tolist()
    return str(x)


def process_unique_path(
    directory: str, prefix: str, suffix: str = ".jsonl"
) -> str:
    """A writer-unique path under ``directory``: host short-name + pid +
    a random token. Pid alone is not unique across the hosts of a
    multi-slice job, and pids get recycled within one host — the token
    covers both."""
    host = socket.gethostname().split(".")[0] or "host"
    token = uuid.uuid4().hex[:8]
    return os.path.join(directory, f"{prefix}-{host}-{os.getpid()}-{token}{suffix}")


class JsonlSink:
    def __init__(self, path: str) -> None:
        self.path = path
        self._fd: int | None = None

    def write(self, record: dict[str, Any]) -> None:
        if self._fd is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._fd = os.open(
                self.path, os.O_CREAT | os.O_WRONLY | os.O_APPEND, 0o644
            )
        data = (json.dumps(_jsonable(record)) + "\n").encode("utf-8")
        # single write syscall per line: O_APPEND makes it atomic with
        # respect to other appenders, and there is no userspace buffer to
        # lose on crash (the old sink buffered then flushed)
        os.write(self._fd, data)

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None
