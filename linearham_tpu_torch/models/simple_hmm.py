"""SimpleHMM: the star-tree HMM (each sequence an independent emission).

Counterpart of linearham_tpu/models/simple_hmm.py.  The star-tree model
treats each observed sequence as an independent draw given the naive base,
as partis assumes (reference: src/SimpleHMM.cpp).  It is the CPU-runnable
conformance target; PhyloHMM is the production model.  Emissions are the
JAX package's jax-free host ``compiler/emissions.star_emissions``;
transitions come from the port's ``compiler/compiled.py``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch import nn

from linearham_tpu_torch.compiler.compiled import compile_family
from linearham_tpu_torch.compiler.emissions import star_emissions
from linearham_tpu_torch.compiler.state_space import build_state_space
from linearham_tpu_torch.io.germline import load_gene_map
from linearham_tpu_torch.io.partis import ClusterData, load_cluster
from linearham_tpu_torch.models.decode import Annotation, decode_paths_batch
from linearham_tpu_torch.ops.ffbs import (SampledPath, path_to_numpy,
                                          sample_path)
from linearham_tpu_torch.ops.forward import ForwardCache, forward, widen_cache
from linearham_tpu_torch.ops.viterbi import viterbi
from linearham_tpu_torch.utils.runtime import resolve_device


class SimpleHMM(nn.Module):
    """Star-tree HMM over one clonal family, on one device in one dtype.

    ``device=None`` means CUDA (raises without one).  The dtype defaults to
    f64 on every device, as in the JAX package: this model is a
    conformance target.  Draws come from ``self.generator``, seeded with
    ``seed`` on the model's device.
    """

    def __init__(self, yaml_path: str, cluster_ind: int, hmm_param_dir: str,
                 seed: int = 0, device=None,
                 dtype: torch.dtype = torch.float64):
        super().__init__()
        self.device = resolve_device(device)
        self.dtype = dtype
        self.cluster: ClusterData = load_cluster(yaml_path, cluster_ind)
        self.genes = load_gene_map(hmm_param_dir)
        self.space = build_state_space(
            self.cluster.locus, self.cluster.flexbounds, self.cluster.relpos,
            self.genes)
        self.heavy = self.space.is_heavy
        self.msa = self.cluster.msa_codes(self.space.alphabet)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

        trans = compile_family(self.space, self.genes).host_transitions()
        emis = star_emissions(self.space, self.genes, self.msa)
        self._trans_keys, self._emis_keys = list(trans), list(emis)
        for prefix, arrays in (("trans", trans), ("emis", emis)):
            for k, v in arrays.items():
                t = torch.as_tensor(np.asarray(v), dtype=dtype,
                                    device=self.device)
                # Emissions carry the one-tree batch axis forward expects.
                self.register_buffer(f"{prefix}_{k}",
                                     t if prefix == "trans" else t[None])
        self._loglik = None
        self._cache = None
        self.map_score = None

    @property
    def trans(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, f"trans_{k}") for k in self._trans_keys}

    @property
    def emis(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, f"emis_{k}") for k in self._emis_keys}

    def _run_forward(self) -> ForwardCache:
        if self._cache is None:
            loglik, self._cache = forward(self.trans, self.emis, self.heavy)
            self._loglik = float(loglik[0])
        return self._cache

    def log_likelihood(self) -> float:
        self._run_forward()
        return self._loglik

    def sample_naive_sequence(self) -> Annotation:
        """Draw one posterior V(D)J path and decode it."""
        return self.sample_annotations(1)[0]

    def sample_annotations(self, n: int) -> List[Annotation]:
        """Draw ``n`` posterior paths in one batched backward walk."""
        path = sample_path(self.generator, self.trans,
                           widen_cache(self._run_forward(), n), self.heavy)
        return self._decode(path)

    def map_annotation(self) -> Annotation:
        """The MAP (Viterbi) V(D)J annotation; its joint log-probability is
        left in ``self.map_score``."""
        score, path = viterbi(self.trans, self.emis, self.heavy)
        self.map_score = float(score[0])
        return self._decode(path)[0]

    def _decode(self, path: SampledPath) -> List[Annotation]:
        p = path_to_numpy(path)
        return decode_paths_batch(
            self.space, vgerm_idx=p.vgerm_idx, vd_idx=p.vd_idx,
            dgerm_idx=p.dgerm_idx, dj_idx=p.dj_idx, jgerm_idx=p.jgerm_idx,
            n_sites=self.cluster.n_sites)
