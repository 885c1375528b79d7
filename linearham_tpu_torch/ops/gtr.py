"""GTR substitution model and discrete-gamma rates (host numpy + torch).

Counterpart of linearham_tpu/ops/gtr.py, whose host functions are numpy
inside but whose module imports jax.  The GTR rate matrix Q is built from 6
exchangeabilities (RevBayes order AC, AG, AT, CG, CT, GT) and a stationary
distribution pi, normalized to one expected substitution per unit branch
length, and eigendecomposed through its similarity-symmetrized form
(reference boundary: src/PhyloHMM.cpp:350-370).  Gamma categories use the
mean-per-category discretization (PLL_GAMMA_RATES_MEAN,
src/PhyloHMM.cpp:360,425).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from scipy.stats import gamma as _gamma_dist


def gamma_category_rates(alpha: float, n_rates: int) -> np.ndarray:
    """Mean-per-category discrete gamma rates (host, float64). [n_rates]"""
    return gamma_category_rates_batch([alpha], n_rates)[0]


def gamma_category_rates_batch(alphas, n_rates: int) -> np.ndarray:
    """Discrete gamma rates for a [T] batch of shapes: [T, n_rates]."""
    alphas = np.asarray(alphas, np.float64)
    T = alphas.shape[0]
    if n_rates == 1:
        return np.ones((T, 1))
    a = alphas[:, None]
    # X ~ Gamma(shape=alpha, rate=alpha), mean 1; bin edges are quantiles.
    edges = _gamma_dist.ppf(
        (np.arange(1, n_rates) / n_rates)[None, :], a, scale=1.0 / a)
    edges = np.concatenate(
        [np.zeros((T, 1)), edges, np.full((T, 1), np.inf)], axis=1)
    # E[X; a<X<b] = F_{alpha+1}(b) - F_{alpha+1}(a) for mean-1 gamma.
    cdf_up = _gamma_dist.cdf(edges, a + 1.0, scale=1.0 / a)
    return n_rates * np.diff(cdf_up, axis=1)


class GTREigen(NamedTuple):
    """Eigendecomposition of Q: P(t) = U @ diag(exp(lam * t)) @ Uinv.

    Leaves are numpy arrays on the host or tensors on a device."""

    u: object       # [..., 4, 4]
    u_inv: object   # [..., 4, 4]
    lam: object     # [..., 4]


def gtr_eigen(er, pi) -> GTREigen:
    """Eigendecompose normalized GTR on the host; batches over leading axes.

    er: [..., 6] exchangeabilities (AC, AG, AT, CG, CT, GT); pi: [..., 4].
    """
    er = np.asarray(er, np.float64)
    pi = np.asarray(pi, np.float64)
    batch = er.shape[:-1]
    R = np.zeros(batch + (4, 4))
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    for k, (i, j) in enumerate(pairs):
        R[..., i, j] = er[..., k]
        R[..., j, i] = er[..., k]

    Q = R * pi[..., None, :]
    Q = Q - np.eye(4) * Q.sum(axis=-1, keepdims=True)
    # Normalize to mean rate 1: -sum_i pi_i Q_ii = 1.
    mean_rate = -np.sum(
        pi * np.diagonal(Q, axis1=-2, axis2=-1), axis=-1,
        keepdims=True)[..., None]
    Q = Q / mean_rate

    sqrt_pi = np.sqrt(pi)
    sym = Q * (sqrt_pi[..., :, None] / sqrt_pi[..., None, :])
    lam, v = np.linalg.eigh(sym)
    u = v / sqrt_pi[..., :, None]
    u_inv = np.swapaxes(v, -1, -2) * sqrt_pi[..., None, :]
    return GTREigen(u=u, u_inv=u_inv, lam=lam)


def transition_matrices(eig: GTREigen, t: torch.Tensor) -> torch.Tensor:
    """P(t) for a stack of times; t broadcasts against eig's batch shape.

    Returns [..., t_shape..., 4, 4] row-stochastic matrices.
    """
    expd = torch.exp(eig.lam[..., None, :] * t[..., :, None])  # [..., T, 4]
    return torch.einsum("...ij,...tj,...jk->...tik", eig.u, expd, eig.u_inv)
