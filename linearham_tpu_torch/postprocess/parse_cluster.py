"""Clonal-family (cluster) selection from partis output.

Select one cluster by partition/cluster index or seed sequence id, then
write a single-event cluster YAML and the clonal-family FASTA (naive
sequence first, indel-reversed member sequences when requested).
Reference contract: scripts/parse_cluster.py -- reimplemented directly on
the partis YAML structure instead of partis' own libraries.
"""

from __future__ import annotations

import warnings
from collections import OrderedDict
from typing import Optional

import yaml

from linearham_tpu_torch.utils.seqs import write_fasta


def _select_event(root: dict, partition_index: Optional[int],
                  cluster_index: Optional[int],
                  seed_unique_id: Optional[str]) -> dict:
    events = root.get("events") or []
    if not events:
        raise ValueError("partis output has no events")
    if len(events) == 1:
        return events[0]

    partitions = (root.get("partitions") or [])
    if not partitions:
        raise ValueError("partis output has no partitions to choose among")
    if partition_index is None:
        # best partition: highest logprob
        partition_index = max(
            range(len(partitions)),
            key=lambda i: partitions[i].get("logprob", float("-inf")))
    ptn = partitions[partition_index]["partition"]

    clusters = ptn if cluster_index is None else [ptn[cluster_index]]
    if seed_unique_id is not None:
        clusters = [c for c in clusters if seed_unique_id in c]
    if len(clusters) != 1:
        listing = "\n".join(
            f"  index={i} size={len(c)} ids={' '.join(c)}"
            for i, c in enumerate(ptn))
        raise ValueError(
            "options must identify exactly 1 cluster, got "
            f"{len(clusters)}; available clusters:\n{listing}")

    wanted = ":".join(clusters[0])
    for ev in events:
        if ":".join(ev["unique_ids"]) == wanted:
            return ev
    raise ValueError(f"no annotation found for cluster {wanted!r}")


def parse_cluster(
    partis_yaml_path: str,
    yaml_output_path: str,
    fasta_output_path: str,
    partition_index: Optional[int] = None,
    cluster_index: Optional[int] = None,
    seed_unique_id: Optional[str] = None,
    indel_reversed_seqs: bool = False,
) -> dict:
    """Write the cluster YAML + FASTA; returns the selected event."""
    with open(partis_yaml_path) as fh:
        root = yaml.safe_load(fh)
    event = _select_event(root, partition_index, cluster_index,
                          seed_unique_id)

    for uid in event["unique_ids"]:
        if "naive" in str(uid):
            warnings.warn(
                f"cluster member {uid!r} looks like a naive sequence; "
                "linearham adds the partis naive sequence itself, so this "
                "cluster will carry two near-identical naive sequences")

    seqs = OrderedDict([("naive", event["naive_seq"])])
    reversed_seqs = event.get("indel_reversed_seqs") or []
    for i, uid in enumerate(event["unique_ids"]):
        if indel_reversed_seqs and i < len(reversed_seqs) \
                and reversed_seqs[i]:
            seqs[str(uid)] = reversed_seqs[i]
        else:
            seqs[str(uid)] = event["input_seqs"][i]

    with open(yaml_output_path, "w") as fh:
        yaml.safe_dump(
            {"germline-info": root.get("germline-info", {}),
             "events": [event]},
            fh, sort_keys=False, width=10 ** 6)
    write_fasta(seqs, fasta_output_path)
    return event
