"""Shared atomic-write helper.

The workflow's resume logic treats any existing output file as a
completed artifact (workflow.py freshness checks, mirroring SCons'
up-to-date skips, SConstruct:208), so every writer in the package must
guarantee a crashed run leaves either the complete file or nothing.
One helper instead of four hand-rolled tmp-then-rename blocks.
"""

from __future__ import annotations

import contextlib
import os
import tempfile


@contextlib.contextmanager
def atomic_write(path: str, mode: str = "w"):
    """Write to a temp file in ``path``'s directory; rename into place
    only if the block completes.  On any exception the temp file is
    removed and nothing appears at ``path``.  mkstemp names keep
    concurrent writers of the same artifact from colliding (last rename
    wins, both files complete)."""
    dirn = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(dirn, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dirn, suffix=".partial")
    try:
        with os.fdopen(fd, mode) as fh:
            yield fh
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
