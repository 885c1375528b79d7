"""Build and load the port's C++ host library (``csrc/native/*.cpp``).

The batch Newick parser, the trees-TSV reader, the schedule builder and the
output-TSV row formatter are compiled with ``g++`` into one shared library
at first use, from the sources in the checkout only, into ``build/native/``
at the repository root, keyed by a hash of the sources, the flags and the
compiler's version (an edited source is rebuilt, an unchanged one reused).
The build goes to a temporary name and is renamed into place, so concurrent
processes each see a whole file.  Without a compiler, or where
``build/native/`` cannot be created, ``build_native`` returns None and
``io/native.py``'s callers take their Python paths.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

REPO_ROOT = Path(__file__).resolve().parents[2]
SOURCE_DIR = Path(__file__).resolve().parents[1] / "csrc" / "native"
SOURCES = ("newick_parser.cpp", "trees_tsv.cpp", "schedule.cpp",
           "output_tsv.cpp")
BUILD_DIR = REPO_ROOT / "build" / "native"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")


def build_native() -> Optional[Path]:
    """Path of the built library, or None where it cannot be built."""
    cxx = os.environ.get("CXX", "g++")
    try:
        version = subprocess.run([cxx, "--version"], capture_output=True,
                                 text=True, check=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    sources = [SOURCE_DIR / s for s in SOURCES]
    h = hashlib.sha256()
    for s in sources:
        h.update(s.read_bytes())
    h.update("\0".join((cxx, *CXX_FLAGS, version)).encode())
    lib = BUILD_DIR / f"liblinearham_native-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    try:   # a read-only install, or a file where a directory should be
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    except OSError:
        return None
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, sources)],
                       check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, lib)
    return lib
