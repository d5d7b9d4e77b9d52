"""Before/after function diff helpers — the git-binary-free equivalent.

The reference shells out to ``git diff --no-index`` to find added/removed
lines between func_before and func_after (reference: baselines/utils/git.py:
13-168; used by the cleaning step to attach per-row diff info). difflib
computes the identical unified diff without the git binary.

A copy of ``mvuld_tpu/tools/gitdiff.py`` (the port imports nothing of the JAX
package). It imports no pandas; ``mark_vulnerable_lines`` takes a
DataFrame.
"""

from __future__ import annotations

import difflib
from typing import Dict, List


def gitdiff(before: str, after: str) -> str:
    """Unified diff text between two function bodies."""
    return "\n".join(difflib.unified_diff(
        before.splitlines(), after.splitlines(),
        fromfile="before", tofile="after", lineterm=""))


def code2diff(before: str, after: str) -> Dict[str, List[int]]:
    """Added/removed line numbers (1-based, in their own versions)
    (reference: git.py code2diff + allfunc)."""
    sm = difflib.SequenceMatcher(a=before.splitlines(), b=after.splitlines())
    removed, added = [], []
    for tag, i1, i2, j1, j2 in sm.get_opcodes():
        if tag in ("replace", "delete"):
            removed.extend(range(i1 + 1, i2 + 1))
        if tag in ("replace", "insert"):
            added.extend(range(j1 + 1, j2 + 1))
    return {"removed": removed, "added": added,
            "diff": gitdiff(before, after)}


def mark_vulnerable_lines(df, before_col: str = "func_before",
                          after_col: str = "func_after"):
    """Attach removed/added line info per row (the dfmp c2dhelper pass,
    process_dataset.py:32-56). Rows without an ``after`` get empty lists."""
    out_removed, out_added = [], []
    for _, row in df.iterrows():
        after = row.get(after_col)
        if not isinstance(after, str) or row[before_col] == after:
            out_removed.append([])
            out_added.append([])
            continue
        d = code2diff(row[before_col], after)
        out_removed.append(d["removed"])
        out_added.append(d["added"])
    df = df.copy()
    df["removed_lines"] = out_removed
    df["added_lines"] = out_added
    return df
