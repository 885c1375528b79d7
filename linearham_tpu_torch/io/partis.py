"""Ingestion of partis output YAML (clonal-family cluster data).

The partis output contract (reference: src/HMM.cpp:27-83): a top-level
``germline-info.locus`` plus an ``events`` list, one event per clonal
family, carrying ``unique_ids``, ``naive_seq``, ``input_seqs`` /
``indel_reversed_seqs`` + ``has_shm_indels``, and the ``linearham-info``
block (``flexbounds`` site windows and per-gene ``relpos``) produced by
``partis get-linearham-info``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from linearham_tpu_torch.io.yaml_load import load_yaml


@dataclass
class ClusterData:
    """One clonal family, ready for state-space compilation."""

    locus: str
    unique_ids: List[str]
    naive_seq: str
    seqs: List[str]                     # indel-reversed where applicable
    flexbounds: Dict[str, Tuple[int, int]]
    relpos: Dict[str, int]
    raw_event: dict                     # full partis event for output plumbing

    @property
    def n_seqs(self) -> int:
        return len(self.seqs)

    @property
    def n_sites(self) -> int:
        return len(self.naive_seq)

    def msa_codes(self, alphabet: str) -> np.ndarray:
        """Integer-encode the alignment, [n_seqs, n_sites]."""
        lut = {c: i for i, c in enumerate(alphabet)}
        out = np.empty((self.n_seqs, self.n_sites), dtype=np.int32)
        for i, seq in enumerate(self.seqs):
            out[i] = [lut[c] for c in seq]
        return out


def load_cluster(yaml_path: str, cluster_ind: int) -> ClusterData:
    """Load one clonal family from a partis output YAML file."""
    with open(yaml_path) as fh:
        root = load_yaml(fh)
    try:
        locus = root["germline-info"]["locus"]
        event = root["events"][cluster_ind]
    except (KeyError, IndexError, TypeError) as exc:
        raise ValueError(
            f"cannot read 'germline-info.locus' / 'events[{cluster_ind}]' "
            f"from {yaml_path}: {exc}"
        )
    info = event.get("linearham-info")
    if not info or "flexbounds" not in info or "relpos" not in info:
        raise ValueError(
            f"{yaml_path} lacks 'linearham-info' (flexbounds/relpos); run "
            "partis get-linearham-info first"
        )

    seqs = []
    for i in range(len(event["unique_ids"])):
        key = "indel_reversed_seqs" if event["has_shm_indels"][i] \
            else "input_seqs"
        seqs.append(event[key][i])

    return ClusterData(
        locus=locus,
        unique_ids=[str(u) for u in event["unique_ids"]],
        naive_seq=event["naive_seq"],
        seqs=seqs,
        flexbounds={k: (int(v[0]), int(v[1]))
                    for k, v in info["flexbounds"].items()},
        relpos={str(k): int(v) for k, v in info["relpos"].items()},
        raw_event=event,
    )
