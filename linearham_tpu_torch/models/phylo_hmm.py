"""PhyloHMM: the V(D)J HMM with phylogenetic-tree emissions, in torch.

Counterpart of linearham_tpu/models/phylo_hmm.py.  Emissions are per-site
Felsenstein likelihoods over the xMSA conditional on the hidden naive base,
divided by the naive base's stationary probability (the HMM supplies the
naive prior; reference: src/PhyloHMM.cpp:220-238).  A whole batch of
posterior trees runs as one device step: pruning (the hand-written kernel
on CUDA), the naive-prior correction, the region-emission matmuls, then
forward and FFBS (``phylo_step``) or Viterbi (``phylo_map_step``).

``PhyloHMM`` is an ``nn.Module`` whose buffers are the family-constant
tensors (transitions, emission maps, xMSA rows), placed once on its device
in its dtype.  Trees are encoded as slot-reuse pruning schedules
(linearham_tpu/io/schedule.py) on every device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from linearham_tpu_torch.compiler.compiled import compile_family
from linearham_tpu_torch.compiler.state_space import build_state_space
from linearham_tpu_torch.compiler.xmsa import Xmsa, build_xmsa, segment_matrix
from linearham_tpu_torch.io.germline import load_gene_map
from linearham_tpu_torch.io.newick import TreeBatch, batch_trees, parse_newick
from linearham_tpu_torch.io.partis import ClusterData, load_cluster
from linearham_tpu_torch.io.schedule import PruningSchedule, build_schedule
from linearham_tpu_torch.models.decode import Annotation, decode_paths_batch
from linearham_tpu_torch.ops.ffbs import (SampledPath, path_to_numpy,
                                          sample_path)
from linearham_tpu_torch.ops.forward import ForwardCache, forward, widen_cache
from linearham_tpu_torch.ops.gtr import (GTREigen, gamma_category_rates,
                                         gtr_eigen)
from linearham_tpu_torch.ops.pruning_cuda import (check_schedule,
                                                  site_log_likelihoods)
from linearham_tpu_torch.ops.viterbi import viterbi
from linearham_tpu_torch.utils import profiling
from linearham_tpu_torch.utils.runtime import (full_f32_matmuls,
                                               resolve_device, resolve_dtype,
                                               to_device)

# Stand-in for -inf while emissions flow through matmuls (0 * -inf = NaN
# would poison the one-hot contractions); exp(_NEG_CAP - anything) == 0 in
# both f32 and f64, and summing a whole region of them stays finite.
_NEG_CAP = -1e30


def gather_consts(space, xmsa: Xmsa) -> dict:
    """Host index maps that turn site log-liks into region emissions.

    Same format as linearham_tpu/models/phylo_hmm.py:_gather_consts: a
    linear region stores ``m`` [X, G] (how many of gene g's sites map to
    xMSA column x), a junction stores its column indices ``inds`` [rows, S]
    (-1 = dead cell) and ``mask``.
    """
    consts = {}
    X = xmsa.n_cols

    def linear(name, region, inds):
        seg = segment_matrix(inds, region.ggene_ranges,
                             len(region.ggene_ranges))
        m = np.zeros((X, seg.shape[1]))
        np.add.at(m, np.asarray(inds, np.intp), seg)
        consts[name] = {"m": m.astype(np.int16)}

    def junction(name, inds):
        consts[name] = {"inds": np.asarray(inds, np.int32),
                        "mask": np.asarray(inds >= 0)}

    linear("vpadding", space.vpadding, xmsa.inds.vpadding)
    linear("vgerm", space.vgerm, xmsa.inds.vgerm)
    junction("vd_junction", xmsa.inds.vd_junction)
    if space.is_heavy:
        linear("dgerm", space.dgerm, xmsa.inds.dgerm)
        junction("dj_junction", xmsa.inds.dj_junction)
    linear("jgerm", space.jgerm, xmsa.inds.jgerm)
    linear("jpadding", space.jpadding, xmsa.inds.jpadding)
    return consts


def place_consts(consts_np: dict, n_cols: int, device: torch.device,
                 dtype: torch.dtype) -> Dict[str, Dict[str, torch.Tensor]]:
    """Device form of the emission maps.  A junction's one-hot selection
    matrix [X, rows*S] is built here, once per family (the JAX package
    rebuilds it inside every step to keep it off a remote relay's wire)."""
    out = {}
    for name, c in consts_np.items():
        if "m" in c:
            out[name] = {"m": torch.as_tensor(c["m"], dtype=dtype,
                                              device=device)}
            continue
        flat = np.maximum(np.asarray(c["inds"]), 0).reshape(-1)
        onehot = np.zeros((n_cols, flat.size))
        onehot[flat, np.arange(flat.size)] = 1.0
        out[name] = {
            "onehot": torch.as_tensor(onehot, dtype=dtype, device=device),
            "mask": torch.as_tensor(np.asarray(c["mask"]), device=device),
        }
    return out


def region_emissions(site_loglik: torch.Tensor, consts: dict,
                     heavy: bool) -> Dict[str, torch.Tensor]:
    """Contract per-site log-likelihoods [T, X] into region emissions.

    Pure matmuls against the one-hot maps of ``place_consts``; -inf sites
    are capped first so 0 * -inf never occurs.  Matmuls run at full f32
    (utils.runtime.full_f32_matmuls): a germline region sums hundreds of
    site log-likelihoods, and TF32 rounding would random-walk the sum.
    """
    safe = torch.clamp(site_loglik, min=_NEG_CAP)
    T = safe.shape[0]
    emis = {}
    linear = ("vpadding", "vgerm", "dgerm", "jgerm", "jpadding") if heavy \
        else ("vpadding", "vgerm", "jgerm", "jpadding")
    for name in linear:
        emis[name] = safe @ consts[name]["m"]
    for name in ("vd_junction", "dj_junction") if heavy else ("vd_junction",):
        c = consts[name]
        vals = (safe @ c["onehot"]).reshape((T,) + tuple(c["mask"].shape))
        emis[name] = torch.where(c["mask"][None], vals,
                                 torch.full_like(vals, -torch.inf))
    return emis


def naive_prior_correction(site_ll: torch.Tensor, pi: torch.Tensor,
                           naive_bases: torch.Tensor) -> torch.Tensor:
    """Divide out the naive base's stationary probability at unambiguous
    naive sites: site_ll[t, x] - log pi[t, naive[x]]."""
    col = torch.clamp(naive_bases.long(), max=3)
    log_pi = torch.log(pi.to(site_ll.dtype))[:, col]             # [T, X]
    return site_ll - torch.where(naive_bases[None] < 4, log_pi,
                                 torch.zeros_like(log_pi))


def phylo_emissions(consts, xmsa_rows, naive_bases, sched: dict,
                    eig: GTREigen, pi, rates, heavy: bool, n_slots: int):
    """Pruning + naive-prior correction + region emissions.

    Returns (emission dict for the forward pass, corrected site log-liks
    [T, X]).
    """
    site_ll = site_log_likelihoods(
        eig, pi, rates, xmsa_rows, sched["sched_src"], sched["sched_penc"],
        sched["sched_len"], sched["sched_root"], n_slots)
    site_ll_corr = naive_prior_correction(site_ll, pi, naive_bases)
    return region_emissions(site_ll_corr, consts, heavy), site_ll_corr


def phylo_step(trans, consts, xmsa_rows, naive_bases, sched: dict,
               eig: GTREigen, pi, rates,
               generator: Optional[torch.Generator], heavy: bool,
               n_slots: int):
    """One pipeline step over a tree batch: one pruning launch, then
    ``phylo_step_from_site_ll``.

    Returns (loglik [T], xmsa emission [T, X], sampled path or None).
    """
    site_ll = site_log_likelihoods(
        eig, pi, rates, xmsa_rows, sched["sched_src"], sched["sched_penc"],
        sched["sched_len"], sched["sched_root"], n_slots)
    return phylo_step_from_site_ll(trans, consts, naive_bases, site_ll, pi,
                                   generator, heavy)


def phylo_step_from_site_ll(trans, consts, naive_bases, site_ll, pi,
                            generator: Optional[torch.Generator],
                            heavy: bool):
    """The step after pruning: naive-prior correction, region emissions,
    forward, then FFBS when a generator is given.  ``site_ll`` [T, X] may be
    a slice of a larger launch's output (the repertoire path).

    Returns (loglik [T], xmsa emission [T, X], sampled path or None).
    """
    site_ll_corr = naive_prior_correction(site_ll, pi, naive_bases)
    loglik, cache = forward(trans, region_emissions(site_ll_corr, consts,
                                                    heavy), heavy)
    path = sample_path(generator, trans, cache, heavy) \
        if generator is not None else None
    return loglik, torch.exp(site_ll_corr), path


def phylo_map_step(trans, consts, xmsa_rows, naive_bases, sched: dict,
                   eig: GTREigen, pi, rates, heavy: bool, n_slots: int):
    """Viterbi variant of phylo_step: (MAP joint log-prob [T], MAP path)."""
    emis, _ = phylo_emissions(consts, xmsa_rows, naive_bases, sched, eig, pi,
                              rates, heavy, n_slots)
    return viterbi(trans, emis, heavy)


def host_products(cluster: ClusterData, genes, msa: np.ndarray) -> dict:
    """All family-constant host arrays (numpy).  The keys match the dict
    linearham_tpu's ``PhyloHMM._host_products`` returns, so a family built
    by either package can be handed to ``PhyloHMM.from_host_products``.

    Span (``utils.profiling``): state_space (the layout and its transition
    tables, for either chain).  Counter: light_chain_families (a family
    on an igk or igl locus)."""
    with profiling.span("state_space"):
        space = build_state_space(
            cluster.locus, cluster.flexbounds, cluster.relpos, genes)
        family = compile_family(space, genes)
    if not space.is_heavy:
        profiling.count("light_chain_families")
    xmsa = build_xmsa(space, msa, cluster.unique_ids)
    return {
        "cluster": cluster,
        "genes": genes,
        "space": space,
        "family": family,
        "msa": msa,
        "xmsa": xmsa,
        "trans_np": family.host_transitions(np.float64),
        "consts_np": gather_consts(space, xmsa),
        "xmsa_rows_np": np.asarray(xmsa.matrix, np.int32),
        "naive_bases_np": np.asarray(xmsa.naive_bases, np.int32),
    }


def load_host_products(yaml_path: str, cluster_ind: int,
                       hmm_param_dir: str,
                       gene_maps: Optional[dict] = None) -> dict:
    """``host_products`` of one family read from its partis YAML and its
    germline parameter directory.

    ``gene_maps`` (optional, owned by the caller) maps a germline directory
    to its parsed gene map, so the families of one call parse a directory
    they share once: the directory is parsed only when absent, then stored.
    Nothing of a family's build writes to the map.

    Spans (``utils.profiling``): load_cluster, load_gene_map (a parse only),
    compile (state space, transitions, xMSA, emission maps; ``state_space``
    inside it).  Counters: gene_map_parses, gene_map_shared (a map taken
    from ``gene_maps``), light_chain_families, and ``io.yaml_load``'s
    yaml_libyaml_loads (or yaml_python_loads): the partis file, and each
    gene file of a parse."""
    with profiling.span("load_cluster"):
        cluster = load_cluster(yaml_path, cluster_ind)
    genes = None if gene_maps is None else gene_maps.get(hmm_param_dir)
    if genes is None:
        with profiling.span("load_gene_map"):
            genes = load_gene_map(hmm_param_dir)
        profiling.count("gene_map_parses")
        if gene_maps is not None:
            gene_maps[hmm_param_dir] = genes
    else:
        profiling.count("gene_map_shared")
    with profiling.span("compile"):
        msa = cluster.msa_codes(next(iter(genes.values())).alphabet + "N")
        return host_products(cluster, genes, msa)


@dataclass
class PhyloParams:
    er: List[float]
    pi: List[float]
    alpha: float
    num_rates: int
    rates: np.ndarray


class PhyloHMM(nn.Module):
    """Phylo-HMM over one clonal family, on one device in one dtype.

    ``device=None`` means CUDA (raises without one); ``dtype=None`` means
    f32 on CUDA and f64 on the CPU.  Both are fixed at construction.
    """

    def __init__(self, yaml_path: str, cluster_ind: int, hmm_param_dir: str,
                 seed: int = 0, device=None, dtype=None):
        super().__init__()
        self._install(load_host_products(yaml_path, cluster_ind,
                                         hmm_param_dir), seed, device, dtype)

    @classmethod
    def from_parts(cls, locus, flexbounds, relpos, genes, msa, unique_ids,
                   n_sites, seed: int = 0, device=None,
                   dtype=None) -> "PhyloHMM":
        """Build directly from in-memory data (synthetic families, tests)."""
        cluster = ClusterData(
            locus=locus, unique_ids=list(unique_ids), naive_seq="N" * n_sites,
            seqs=[], flexbounds=dict(flexbounds), relpos=dict(relpos),
            raw_event={})
        return cls.from_host_products(host_products(cluster, genes, msa),
                                      device, dtype, seed)

    @classmethod
    def from_host_products(cls, host: dict, device=None, dtype=None,
                           seed: int = 0) -> "PhyloHMM":
        """Build from a host-products dict (see ``host_products``)."""
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        self._install(host, seed, device, dtype)
        return self

    def _install(self, host: dict, seed: int, device, dtype) -> None:
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype, self.device)
        full_f32_matmuls()
        self.cluster: ClusterData = host["cluster"]
        self.genes = host["genes"]
        self.space = host["space"]
        self.msa = host["msa"]
        self.xmsa: Xmsa = host["xmsa"]
        self.heavy = self.space.is_heavy
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

        self._trans_keys = list(host["trans_np"])
        for k, v in host["trans_np"].items():
            self.register_buffer(f"trans_{k}", torch.as_tensor(
                np.asarray(v), dtype=self.dtype, device=self.device))
        self._const_parts = {}
        placed = place_consts(host["consts_np"], self.xmsa.n_cols,
                              self.device, self.dtype)
        for name, parts in placed.items():
            self._const_parts[name] = list(parts)
            for part, t in parts.items():
                self.register_buffer(f"consts_{name}_{part}", t)
        self.register_buffer("xmsa_rows", torch.as_tensor(
            host["xmsa_rows_np"], dtype=torch.int32, device=self.device))
        self.register_buffer("naive_bases", torch.as_tensor(
            host["naive_bases_np"], dtype=torch.int32, device=self.device))

        self.params: Optional[PhyloParams] = None
        self.tree_batch: Optional[TreeBatch] = None
        self._schedule: Optional[PruningSchedule] = None
        self._loglik = None
        self._xmsa_emission = None
        self.map_score: Optional[float] = None

    @property
    def trans(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, f"trans_{k}") for k in self._trans_keys}

    @property
    def consts(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {name: {p: getattr(self, f"consts_{name}_{p}") for p in parts}
                for name, parts in self._const_parts.items()}

    # -- batched step ----------------------------------------------------

    def ensemble_inputs(self, sched: PruningSchedule, eig: GTREigen, pi,
                        rates, idx=None, non_blocking: bool = False):
        """Host arrays of a tree batch (rows ``idx``, default all) -> device
        tensors: (schedule dict, eig, pi, rates).  Indices are checked on
        the host before they reach the kernel."""
        if idx is None:
            idx = np.arange(sched.n_trees)
        part = PruningSchedule(src=sched.src[idx], penc=sched.penc[idx],
                               length=sched.length[idx],
                               root=sched.root[idx], n_slots=sched.n_slots)
        check_schedule(part, self.xmsa.matrix.shape[0])

        def put(a):
            return to_device(a, self.device, self.dtype, non_blocking)

        sched_t = {"sched_src": put(part.src), "sched_penc": put(part.penc),
                   "sched_len": put(part.length), "sched_root": put(part.root)}
        eig_t = GTREigen(*(put(np.asarray(a)[idx]) for a in eig))
        return sched_t, eig_t, put(np.asarray(pi)[idx]), \
            put(np.asarray(rates)[idx])

    def step(self, sched_t: dict, eig_t: GTREigen, pi_t, rates_t,
             generator: Optional[torch.Generator], n_slots: int):
        """phylo_step with this family's constants."""
        return phylo_step(self.trans, self.consts, self.xmsa_rows,
                          self.naive_bases, sched_t, eig_t, pi_t, rates_t,
                          generator, self.heavy, n_slots)

    def step_from_site_ll(self, site_ll, pi_t,
                          generator: Optional[torch.Generator]):
        """phylo_step_from_site_ll with this family's constants."""
        return phylo_step_from_site_ll(self.trans, self.consts,
                                       self.naive_bases, site_ll, pi_t,
                                       generator, self.heavy)

    def map_step(self, sched_t: dict, eig_t: GTREigen, pi_t, rates_t,
                 n_slots: int):
        """phylo_map_step with this family's constants."""
        return phylo_map_step(self.trans, self.consts, self.xmsa_rows,
                              self.naive_bases, sched_t, eig_t, pi_t,
                              rates_t, self.heavy, n_slots)

    # -- single-tree API (mirrors the reference CLI subcommands) ----------

    def init_phylo_parameters(self, newick_path: str, er: Sequence[float],
                              pi: Sequence[float], alpha: float,
                              num_rates: int) -> None:
        with open(newick_path) as fh:
            tree = parse_newick(fh.read())
        # One-slot-per-node arrays (ops/pruning.py) and the kernel's
        # slot-reuse schedule of the same tree.
        self.tree_batch = batch_trees([tree], self.xmsa.labels)
        self._schedule = build_schedule(self.tree_batch)
        self.params = PhyloParams(
            er=list(er), pi=list(pi), alpha=float(alpha),
            num_rates=num_rates,
            rates=gamma_category_rates(float(alpha), num_rates))
        self._loglik = None
        self._xmsa_emission = None

    def _tree_inputs(self):
        p = self.params
        return self.ensemble_inputs(self._schedule, gtr_eigen([p.er], [p.pi]),
                                    [p.pi], p.rates[None])

    def _forward_current(self) -> ForwardCache:
        """Emissions + forward for the current tree; caches the
        log-likelihood and xMSA emission on the host."""
        sched, eig, pi, rates = self._tree_inputs()
        emis, site_ll_corr = phylo_emissions(
            self.consts, self.xmsa_rows, self.naive_bases, sched, eig, pi,
            rates, self.heavy, self._schedule.n_slots)
        loglik, cache = forward(self.trans, emis, self.heavy)
        self._loglik = loglik.cpu().numpy()
        self._xmsa_emission = torch.exp(site_ll_corr).cpu().numpy()
        return cache

    def init_phylo_emission(self) -> None:
        """Compute (and cache) the current tree's emissions and
        log-likelihood."""
        self._forward_current()

    def log_likelihood(self) -> float:
        if self._loglik is None:
            self._forward_current()
        return float(self._loglik[0])

    @property
    def xmsa_emission(self) -> np.ndarray:
        if self._xmsa_emission is None:
            self._forward_current()
        return self._xmsa_emission[0]

    def sample_naive_sequence(self) -> Annotation:
        """Draw one posterior V(D)J path under the current tree."""
        return self.sample_annotations(1)[0]

    def sample_annotations(self, n: int) -> List[Annotation]:
        """Draw ``n`` posterior paths under the current tree in one batched
        backward walk over a single forward pass."""
        cache = widen_cache(self._forward_current(), n)
        path = sample_path(self.generator, self.trans, cache, self.heavy)
        return self.decode_batch(path_to_numpy(path))

    def map_annotation(self) -> Annotation:
        """The MAP (Viterbi) V(D)J annotation under the current tree; its
        joint log-probability is left in ``self.map_score``."""
        sched, eig, pi, rates = self._tree_inputs()
        score, path = self.map_step(sched, eig, pi, rates,
                                    self._schedule.n_slots)
        self.map_score = float(score[0])
        return self.decode_batch(path_to_numpy(path))[0]

    def decode_batch(self, path: SampledPath) -> List[Annotation]:
        """Decode a batch of sampled paths (numpy leaves, [T, ...])."""
        return decode_paths_batch(
            self.space, vgerm_idx=path.vgerm_idx, vd_idx=path.vd_idx,
            dgerm_idx=path.dgerm_idx, dj_idx=path.dj_idx,
            jgerm_idx=path.jgerm_idx, n_sites=self.cluster.n_sites)
