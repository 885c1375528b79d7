"""The plain phylo-HMM of one clonal family, in torch, in any dtype.

The model is written out site by site from the partis HMM files, without
the program's collapsed state space, its xMSA or its transition blocks.
At every site of the naive sequence, from the left edge of the V window
to the right edge of the J window, a state says what the site holds:

* ``VP`` / ``JP``: an N of the padding left of gene V or right of gene J;
* ``VG`` / ``DG`` / ``JG``: gene g's germline base at the site (the gene's
  position is the site less its ``relpos``);
* ``DN`` / ``JN``: a non-templated base x inserted left of gene D or J.

Where each state may stand follows from the partis ``flexbounds``: a V
gene from its start to the D (light chain: J) window, a D gene from the V
window's right edge to the J window, insertions inside the junction
windows, paddings out to the sequence's ends.  A path steps from site to
site with the probabilities the gene files give: within a gene its
``transition``, out of it ``landing_out`` times the next gene's
``gene_prob`` and ``landing_in`` (or NTI ``landing_in``), among
insertions the NTI matrix, from them ``nti_landing_out``; the paddings
are geometric in the gene's N self-transition p (p per padded site, 1 - p
to leave).

A state's emission is the tree's likelihood of the site's column with the
naive tip set to the state's base (all four for an N), less log pi of
that base: Felsenstein pruning over each posterior tree, P(t) = expm(Q t)
of the normalised GTR matrix, the root mixed by pi and the mean-rate
gamma categories averaged.  ``log_likelihood`` is the forward algorithm in
log space over the sites, ``path_log_joint`` the log probability of one
given path with the data, and ``sample_paths`` draws paths backwards from
the forward messages (the control's decoder).

Only the file loaders are frozen copies (``frozen/``); nothing here reads
what the program computed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference import newick
from benchmark.reference.frozen.germline import load_gene_map
from benchmark.reference.frozen.partis import load_cluster

_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
N_CODE = 4                      # the naive base N: every tip state allowed
GERM = ("VG", "DG", "JG")
NTI = ("DN", "JN")

# A state: (kind, gene name, inserted base or -1).
Key = Tuple[str, str, int]


def gamma_rates(alpha: Sequence[float], n_rates: int) -> np.ndarray:
    """[T, n_rates] mean rates of equal-probability gamma categories of
    shape ``alpha`` and mean 1 (float64)."""
    from scipy.special import gammainc, gammaincinv

    a = np.asarray(alpha, np.float64)[:, None]
    if n_rates == 1:
        return np.ones((a.shape[0], 1))
    q = np.arange(1, n_rates) / n_rates
    cuts = gammaincinv(a, q[None, :])            # in units of 1 / alpha
    upper = np.concatenate([gammainc(a + 1.0, cuts),
                            np.ones_like(a)], axis=1)
    lower = np.concatenate([np.zeros_like(a), gammainc(a + 1.0, cuts)],
                           axis=1)
    return n_rates * (upper - lower)


def gtr_matrix(er: torch.Tensor, pi: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] GTR rate matrices, one substitution per unit time."""
    R = torch.zeros(er.shape[:-1] + (4, 4), dtype=er.dtype, device=er.device)
    for k, (i, j) in enumerate(_PAIRS):
        R[..., i, j] = er[..., k]
        R[..., j, i] = er[..., k]
    Q = R * pi[..., None, :]
    Q = Q - torch.diag_embed(Q.sum(-1))
    rate = -(pi * torch.diagonal(Q, dim1=-2, dim2=-1)).sum(-1)
    return Q / rate[..., None, None]


@dataclass
class Block:
    """A block of posterior samples of one family, on the device."""

    trees: List[str]
    er: torch.Tensor        # [B, 6]
    pi: torch.Tensor        # [B, 4]
    rates: torch.Tensor     # [B, R]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to nearest (ties to even) at TF32's 11 significant
    bits: what a tensor core reads of a float32 matmul's input.  The
    control rounds its matmul inputs so, whatever kernel the library
    picks for a shape (it may pick one without TF32)."""
    m, e = torch.frexp(x)
    return torch.ldexp(torch.round(m * 2048.0) / 2048.0, e)


def _log(p: float) -> float:
    return float(np.log(p)) if p > 0 else -np.inf


class FamilyModel:
    """One family's sites, the states each may hold, and the steps.
    ``matmul_input`` rounds the pruning's matmul inputs (the control sets
    it to ``tf32``)."""

    matmul_input = staticmethod(lambda x: x)

    @classmethod
    def build(cls, yaml_path: str, cluster_ind: int, gene_dir: str,
              device, dtype, gene_maps: Optional[dict] = None
              ) -> "FamilyModel":
        """``gene_maps`` (optional) keeps each germline directory's parse
        for the next family that shares it."""
        self = cls()
        cluster = load_cluster(yaml_path, cluster_ind)
        if gene_maps is None:
            gene_maps = {}
        if gene_dir not in gene_maps:
            gene_maps[gene_dir] = load_gene_map(gene_dir)
        self.genes = gene_maps[gene_dir]
        self.alphabet = next(iter(self.genes.values())).alphabet
        self.heavy = cluster.locus == "igh"
        self.n_sites = cluster.n_sites
        fb = cluster.flexbounds
        self.relpos = {g: int(p) for g, p in cluster.relpos.items()
                       if g in self.genes and (
                           self.heavy or self.genes[g].gtype != "D")}
        missing = [g for g in cluster.relpos if g not in self.genes]
        if missing:
            raise ValueError(f"relpos names genes with no file: {missing}")
        self.first = fb["v_l"][0]
        self.last = fb["j_r"][1]                 # one past the last site
        self.segments = ("V", "D", "J") if self.heavy else ("V", "J")
        self.live = self._live_ranges(fb)
        self.states: List[List[Key]] = [[] for _ in range(self.n_sites)]
        for key, (lo, hi) in self.live.items():
            for s in range(lo, hi):
                self.states[s].append(key)
        for s in range(self.first, self.last):
            self.states[s].sort()
            if not self.states[s]:
                raise ValueError(f"no state may hold site {s}")
        self.index = [{k: i for i, k in enumerate(st)} for st in self.states]
        self._emission_columns(cluster)
        self.log_steps = [self._step_matrix(s)
                          for s in range(self.first, self.last - 1)]
        self.log_init = np.array([self._init(k) for k in
                                  self.states[self.first]])
        self.log_final = np.array([self._final(k) for k in
                                   self.states[self.last - 1]])
        self.device, self.dtype = torch.device(device), dtype
        self.steps_t = [self._put(m) for m in self.log_steps]
        self.init_t = self._put(self.log_init)
        self.final_t = self._put(self.log_final)
        return self

    # -- where each state may stand ----------------------------------------

    def _live_ranges(self, fb) -> Dict[Key, Tuple[int, int]]:
        heavy, out = self.heavy, {}
        v_end = fb["d_l"][1] if heavy else fb["j_l"][1]
        j_junction = fb["d_r"][0] if heavy else fb["v_r"][0]
        for g, rp in sorted(self.relpos.items()):
            gene = self.genes[g]
            end = rp + gene.length
            if gene.gtype == "V":
                out[("VP", g, -1)] = (self.first, max(rp, self.first))
                out[("VG", g, -1)] = (max(rp, self.first), min(end, v_end))
            elif gene.gtype == "D":
                out[("DG", g, -1)] = (max(rp, fb["v_r"][0]),
                                      min(end, fb["j_l"][1]))
                for x in range(len(self.alphabet)):
                    out[("DN", g, x)] = (fb["v_r"][0], fb["d_l"][1])
            else:
                out[("JG", g, -1)] = (max(rp, j_junction),
                                      min(end, self.last))
                out[("JP", g, -1)] = (min(end, self.last), self.last)
                for x in range(len(self.alphabet)):
                    out[("JN", g, x)] = (j_junction, fb["j_l"][1])
        return {k: v for k, v in out.items() if v[1] > v[0]}

    def base(self, key: Key, site: int) -> int:
        """The naive base a state puts at ``site`` (N_CODE for an N)."""
        kind, g, x = key
        if kind in GERM:
            return int(self.genes[g].bases[site - self.relpos[g]])
        if kind in NTI:
            return x
        return N_CODE

    # -- probabilities from the gene files ----------------------------------

    def _n_self(self, g: str) -> float:
        return float(self.genes[g].n_transition)

    def _init(self, key: Key) -> float:
        kind, g, _ = key
        gene = self.genes[g]
        if kind == "VP":
            return _log(gene.gene_prob * self._n_self(g))
        if kind == "VG":
            return _log(gene.gene_prob * (1.0 - self._n_self(g)))
        return -np.inf

    def _final(self, key: Key) -> float:
        kind, g, _ = key
        return _log(1.0 - self._n_self(g)) if kind in ("JG", "JP") \
            else -np.inf

    def _next_segment(self, gtype: str) -> Optional[str]:
        i = self.segments.index(gtype)
        return self.segments[i + 1] if i + 1 < len(self.segments) else None

    def step(self, a: Key, b: Key, site: int) -> float:
        """P(state ``b`` at site + 1 | state ``a`` at site)."""
        ka, ga, xa = a
        kb, gb, xb = b
        A, B = self.genes[ga], self.genes[gb]
        pa, pb = site - self.relpos[ga], site + 1 - self.relpos[gb]
        if ga == gb:
            if ka in ("VP", "JP") or (ka == "JG" and kb == "JP"):
                if kb == ka:
                    return self._n_self(ga)
                if ka == "VP" and kb == "VG":
                    return 1.0 - self._n_self(ga)
                if ka == "JG" and kb == "JP":
                    return self._n_self(ga)
                return 0.0
            if ka in GERM and kb == ka:
                return float(A.transition[pa])
            if ka in NTI and kb == ka:
                return float(A.nti_transition[xa, xb])
            if ka in NTI and kb in GERM:
                return float(A.nti_landing_out[xa, pb])
            return 0.0
        if ka in GERM and B.gtype == self._next_segment(A.gtype):
            leave = float(A.landing_out[pa]) * float(B.gene_prob)
            if kb in NTI:
                return leave * float(B.nti_landing_in[xb])
            if kb in GERM:
                return leave * float(B.landing_in[pb])
        return 0.0

    def _step_matrix(self, site: int) -> np.ndarray:
        here, there = self.states[site], self.states[site + 1]
        m = np.empty((len(here), len(there)))
        for i, a in enumerate(here):
            for j, b in enumerate(there):
                m[i, j] = self.step(a, b, site)
        with np.errstate(divide="ignore"):
            return np.log(m)

    def _put(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64), dtype=self.dtype,
                               device=self.device)

    # -- emissions ----------------------------------------------------------

    def _emission_columns(self, cluster) -> None:
        """One pruning column per (site, naive base) that some state
        needs; ``flat`` lists every (site, state)'s column, site by
        site, ``offset[s]`` where site s starts in it."""
        lut = {c: i for i, c in enumerate(self.alphabet + "N")}
        msa = np.asarray([[lut[c] for c in seq] for seq in cluster.seqs],
                         np.int64)
        cols: Dict[Tuple[int, int], int] = {}
        flat, self.offset = [], {}
        for s in range(self.first, self.last):
            self.offset[s] = len(flat)
            for key in self.states[s]:
                flat.append(cols.setdefault((s, self.base(key, s)),
                                            len(cols)))
        self.offset[self.last] = len(flat)
        self.n_cols = len(cols)
        codes = np.empty((1 + msa.shape[0], self.n_cols), np.int64)
        for (s, b), c in cols.items():
            codes[0, c] = b
            codes[1:, c] = msa[:, s]
        self.labels = ["naive"] + list(cluster.unique_ids)
        self.row_of = {lab: i for i, lab in enumerate(self.labels)}
        self.tip_codes = codes
        self.flat_cols = np.asarray(flat, np.int64)

    def site_log_likelihoods(self, block: Block) -> torch.Tensor:
        """[B, n_cols] per-column log-likelihoods less log pi of the naive
        base (nothing for an N)."""
        B = len(block.trees)
        R = block.rates.shape[1]
        X = self.n_cols
        roots = [newick.parse(t) for t in block.trees]
        tips_n = len(self.labels)
        internal = [newick.postorder(r) for r in roots]
        n_int = max(len(p) for p in internal)
        n_child = max(len(n.children) for p in internal for n in p)
        ones = tips_n + n_int                  # an all-ones scratch node
        child = np.full((B, n_int, n_child), ones, np.int64)
        length = np.zeros((B, n_int, n_child))
        node_of = np.full((B, n_int), ones, np.int64)
        root = np.zeros(B, np.int64)
        for b, order in enumerate(internal):
            ids = {}
            for k, node in enumerate(order):
                ids[id(node)] = tips_n + k
                node_of[b, k] = tips_n + k
                for c, ch in enumerate(node.children):
                    child[b, k, c] = ids[id(ch)] if ch.children \
                        else self.row_of[ch.label]
                    length[b, k, c] = newick.branch_length(ch)
            root[b] = tips_n + len(order) - 1
        dev, dt = self.device, self.dtype
        Q = gtr_matrix(block.er, block.pi)                       # [B,4,4]
        t = torch.as_tensor(length, dtype=dt, device=dev)
        P = torch.linalg.matrix_exp(
            Q[:, None, None, None] * (t[:, :, :, None, None, None]
                                      * block.rates[:, None, None, :,
                                                    None, None]))
        # P: [B, n_int, n_child, R, 4, 4]
        L = torch.ones((B, ones + 1, R, 4, X), dtype=dt, device=dev)
        codes = torch.as_tensor(self.tip_codes, device=dev)
        tip = (codes[None, :] == torch.arange(4, device=dev)[:, None, None])
        tip = tip | (codes[None, :] >= 4) | (codes[None, :] < 0)
        L[:, :tips_n] = tip.permute(1, 0, 2).to(dt)[None, :, None]
        S = torch.zeros((B, ones + 1, R, X), dtype=dt, device=dev)
        bi = torch.arange(B, device=dev)
        rd = self.matmul_input
        child_t = torch.as_tensor(child, device=dev)
        node_t = torch.as_tensor(node_of, device=dev)
        for k in range(n_int):
            prod = None
            scale = torch.zeros((B, R, X), dtype=dt, device=dev)
            for c in range(n_child):
                ch = child_t[:, k, c]
                msg = torch.matmul(rd(P[:, k, c]), rd(L[bi, ch]))  # [B,R,4,X]
                prod = msg if prod is None else prod * msg
                scale = scale + S[bi, ch]
            m = prod.amax(dim=-2, keepdim=True)
            m = torch.where(m > 0, m, torch.ones_like(m))
            L[bi, node_t[:, k]] = prod / m
            S[bi, node_t[:, k]] = scale + torch.log(m[..., 0, :])
        rt = torch.as_tensor(root, device=dev)
        per_rate = torch.log(torch.einsum("ba,brax->brx", rd(block.pi),
                                          rd(L[bi, rt]))) + S[bi, rt]
        site = torch.logsumexp(per_rate, dim=1) - np.log(R)
        naive = codes[0]
        log_pi = torch.log(block.pi)[:, torch.clamp(naive, 0, 3)]
        return site - torch.where(naive[None] < 4, log_pi,
                                  torch.zeros_like(log_pi))

    def emissions(self, site_ll: torch.Tensor) -> torch.Tensor:
        """[B, every (site, state)] log emissions, site by site."""
        flat = torch.as_tensor(self.flat_cols, device=site_ll.device)
        return torch.clamp(site_ll, min=-1e30)[:, flat]

    def _at(self, emis: torch.Tensor, s: int) -> torch.Tensor:
        return emis[:, self.offset[s]:self.offset[s + 1]]

    # -- the HMM ------------------------------------------------------------

    def forward(self, emis: torch.Tensor) -> List[torch.Tensor]:
        """The forward messages log P(data up to s, state at s), site by
        site."""
        a = self.init_t[None] + self._at(emis, self.first)
        out = [a]
        for i, s in enumerate(range(self.first + 1, self.last)):
            a = torch.logsumexp(a[:, :, None] + self.steps_t[i][None],
                                dim=1) + self._at(emis, s)
            out.append(a)
        return out

    def log_likelihood(self, emis: torch.Tensor,
                       messages: Optional[List[torch.Tensor]] = None
                       ) -> torch.Tensor:
        """[B] log P(data)."""
        last = (messages or self.forward(emis))[-1]
        return torch.logsumexp(last + self.final_t[None], dim=1)

    def path_log_joint(self, emis: torch.Tensor,
                       paths: np.ndarray) -> torch.Tensor:
        """[B] log P(path, data); ``paths`` [B, sites] holds each site's
        state as an index into ``states[site]``."""
        paths = np.asarray(paths, np.int64)
        host = self.log_init[paths[:, 0]] + self.log_final[paths[:, -1]]
        for i in range(paths.shape[1] - 1):
            host = host + self.log_steps[i][paths[:, i], paths[:, i + 1]]
        pos = np.asarray([self.offset[s] for s in
                          range(self.first, self.last)])[None] + paths
        got = emis.gather(1, torch.as_tensor(pos, device=emis.device))
        return self._put(host) + got.sum(dim=1)

    def sample_paths(self, messages: List[torch.Tensor],
                     generator: torch.Generator) -> np.ndarray:
        """[B, sites] paths drawn from the posterior, backwards."""
        w = messages[-1] + self.final_t[None]
        idx = torch.multinomial(torch.softmax(w, dim=1), 1,
                                generator=generator)[:, 0]
        out = [idx]
        for i in range(len(messages) - 2, -1, -1):
            w = messages[i] + self.steps_t[i][:, idx].T
            idx = torch.multinomial(torch.softmax(w, dim=1), 1,
                                    generator=generator)[:, 0]
            out.append(idx)
        return torch.stack(out[::-1], dim=1).cpu().numpy()
