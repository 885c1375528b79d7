"""Disk cache of compiled clonal families.

Counterpart of linearham_tpu/compiler/family_cache.py.  Building a family
(partis YAML parse, germline gene maps, state space, transitions, xMSA,
emission maps) is the largest host stage of the port's pipeline, and
production runs rebuild the same family many times (reruns, resumed
workflows, repeated sampling).  So the host products of
``models.phylo_hmm.load_host_products`` -- numpy arrays and dataclasses,
never tensors -- are pickled on disk, keyed by a content hash of every input:
the format version, the cluster index, the dtype name, the partis YAML
bytes, every gene YAML's bytes, and the port's sources (its host modules
included).  A hit unpickles them and places the tensors on the device
asked for, so the device is never memoised.  Format 1 pickled the JAX
package's classes; the format is in the key, so such an entry is never
read (unpickling it would import that package) and the family is rebuilt.

``LINEARHAM_FAMILY_CACHE=off`` disables the cache; any other value is the
directory.  The default is ``build/family_cache`` at the repository root,
beside the kernel builds.  A corrupt entry is deleted and the family
rebuilt; writes are atomic and best-effort.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from pathlib import Path
from typing import List, Optional

from linearham_tpu_torch.models.phylo_hmm import PhyloHMM, load_host_products
from linearham_tpu_torch.utils.fileio import atomic_write
from linearham_tpu_torch.utils.runtime import resolve_device, resolve_dtype

_FORMAT_VERSION = 2

PORT_DIR = Path(__file__).resolve().parents[1]
DEFAULT_DIR = PORT_DIR.parent / "build" / "family_cache"


def _cache_dir() -> Optional[str]:
    d = os.environ.get("LINEARHAM_FAMILY_CACHE", str(DEFAULT_DIR))
    return None if d == "off" else d


def source_files() -> List[Path]:
    """Every source whose change must invalidate the cache: the port's own
    ``.py`` files."""
    return sorted(PORT_DIR.rglob("*.py"))


def family_key(yaml_path: str, cluster_ind: int, hmm_param_dir: str,
               dtype_name: str) -> str:
    """Content hash of every input that determines the compiled family."""
    h = hashlib.sha256()
    h.update(f"v{_FORMAT_VERSION}|{cluster_ind}|{dtype_name}|".encode())
    for src in source_files():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    with open(yaml_path, "rb") as fh:
        h.update(fh.read())
    for fn in sorted(os.listdir(hmm_param_dir)):
        if fn.endswith((".yaml", ".yml")):
            h.update(fn.encode())
            with open(os.path.join(hmm_param_dir, fn), "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()[:24]


def cached_phylo_hmm(yaml_path: str, cluster_ind: int, hmm_param_dir: str,
                     seed: int = 0, device=None, dtype=None,
                     cache_dir: Optional[str] = None) -> PhyloHMM:
    """``PhyloHMM(yaml_path, cluster_ind, hmm_param_dir, ...)`` through the
    family disk cache.

    Hit: unpickle the host products and place them on ``device``.  Miss:
    build, then persist the host products (atomic rename; concurrent
    writers race benignly).  An unreadable entry is deleted and rebuilt.
    """
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)
    d = cache_dir or _cache_dir()
    path = None if d is None else os.path.join(d, family_key(
        yaml_path, cluster_ind, hmm_param_dir,
        str(dtype).removeprefix("torch.")) + ".pkl")
    if path is not None and os.path.exists(path):
        host = None
        try:
            with open(path, "rb") as fh:
                host = pickle.load(fh)
        except Exception:
            # Only an unreadable pickle means a corrupt entry; a failure
            # past this point (placing on the device) keeps the file.
            try:
                os.unlink(path)
            except OSError:
                pass
        if host is not None:
            return PhyloHMM.from_host_products(host, device, dtype, seed)

    host = load_host_products(yaml_path, cluster_ind, hmm_param_dir)
    if path is not None:
        try:
            with atomic_write(path, "wb") as fh:
                pickle.dump(host, fh)
        except OSError:
            pass  # cache population is best-effort
    return PhyloHMM.from_host_products(host, device, dtype, seed)
