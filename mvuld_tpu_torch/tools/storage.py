"""Storage paths, parallel dataframe map, misc host utilities (the port's
own copy of ``mvuld_tpu/tools/storage.py``; no framework import).

Equivalent of the reference's ``sastvd`` package-level helpers (reference:
mvuld/sastvd/__init__.py:16-207): cache/processed/external/output dirs under
a storage root, ``dfmp`` (multiprocess map over dataframe rows with
per-item exception swallowing — the reference's host-parallelism layer),
``chunks``, ``subprocess_cmd``, and a git-sha run id.
"""

from __future__ import annotations

import os
import subprocess
import uuid
from datetime import datetime
from typing import Any, Callable, Iterable, List, Sequence


def storage_root() -> str:
    return os.environ.get("MVULD_STORAGE", os.path.join(os.getcwd(), "storage"))


def _dir(*parts: str) -> str:
    p = os.path.join(storage_root(), *parts)
    os.makedirs(p, exist_ok=True)
    return p


def cache_dir() -> str:
    return _dir("cache")


def processed_dir() -> str:
    return _dir("processed")


def external_dir() -> str:
    return _dir("external")


def outputs_dir() -> str:
    return _dir("outputs")


def get_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


def chunks(seq: Sequence, n: int) -> Iterable[List]:
    """Split into n-sized chunks (reference: svd.chunks)."""
    for i in range(0, len(seq), n):
        yield list(seq[i:i + n])


def _safe_apply(fn, item):
    try:
        return fn(item)
    except Exception as e:          # per-item swallow (reference behavior,
        print(e)                    # data_list.py:162-164)
        return None


def dfmp(df, function: Callable, columns=None, workers: int = 6,
         ordr: bool = True, desc: str = "") -> List[Any]:
    """Parallel map over dataframe rows (reference: svd.dfmp:171-201).

    ``columns``: None → row dicts; str → that column's values; list → dicts
    of those columns. Uses a process pool when >1 worker is available and the
    function is picklable; falls back to serial otherwise.
    """
    if columns is None:
        items = df.to_dict(orient="records")
    elif isinstance(columns, str):
        items = df[columns].tolist()
    else:
        items = df[columns].to_dict(orient="records")

    workers = min(workers, os.cpu_count() or 1)
    if workers <= 1:
        return [_safe_apply(function, it) for it in items]
    import multiprocessing as mp
    try:
        with mp.Pool(workers) as pool:
            mapper = pool.imap if ordr else pool.imap_unordered
            return list(mapper(function, items))
    except Exception:
        return [_safe_apply(function, it) for it in items]


def subprocess_cmd(command: str, verbose: int = 0) -> tuple:
    """Run a shell command, return (stdout, stderr) (reference helper)."""
    proc = subprocess.Popen(command, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, shell=True)
    out, err = proc.communicate()
    if verbose:
        print(out.decode(errors="replace"), err.decode(errors="replace"))
    return out, err


def get_run_id() -> str:
    """Timestamped run id with the current git sha when available."""
    sha = "nogit"
    try:
        sha = subprocess.check_output(
            ["git", "rev-parse", "--short", "HEAD"],
            stderr=subprocess.DEVNULL).decode().strip()
    except Exception:
        pass
    stamp = datetime.now().strftime("%Y%m%d%H%M")
    return f"{stamp}_{sha}_{uuid.uuid4().hex[:6]}"
