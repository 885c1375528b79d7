"""MCMC effective-sample-size estimation (exact coda replica).

The reference post-processing computes per-parameter ESS with R's
coda::effectiveSize (scripts/run_bootstrap_asr_ess.R:35-40): the spectral
density at frequency zero from an AR fit with AIC-selected order.  This is
a numpy transcription of that exact estimator chain:

  coda::effectiveSize  ->  N * var(x) / spectrum0.ar(x)$spec
  coda::spectrum0.ar   ->  ar.out$var.pred / (1 - sum(ar.out$ar))^2,
                           with a zero-spec short-circuit when the
                           residuals of lm(x ~ seq) have sd 0
  stats::ar (yule-walker, aic=TRUE) ->
      autocovariances with denominator N (stats::acf type="covariance"),
      Levinson-Durbin over orders 0..min(N-1, floor(10*log10(N))),
      order = argmin of N*log(pred_var) + 2*order,
      var.pred = pred_var[order] * N / (N - (order + 1))   <- the
      degrees-of-freedom correction R applies AFTER order selection.

Pinned against hand-checked goldens in tests/test_postprocess.py (an
independent matrix-solve Yule-Walker implementation reproduces the same
numbers to 1e-10).
"""

from __future__ import annotations

import numpy as np


def _autocovariances(x: np.ndarray, max_lag: int) -> np.ndarray:
    """stats::acf(type="covariance"): demeaned, denominator N."""
    n = len(x)
    x = x - x.mean()
    acov = np.empty(max_lag + 1)
    for k in range(max_lag + 1):
        acov[k] = np.dot(x[: n - k], x[k:]) / n
    return acov


def ar_yw(x: np.ndarray):
    """R stats::ar (Yule-Walker, aic=TRUE, demean=TRUE) for one series.

    Returns (order, coefficients [order], var_pred) where var_pred
    carries R's N/(N-(order+1)) correction.
    """
    x = np.asarray(x, float)
    n = len(x)
    order_max = min(n - 1, int(np.floor(10 * np.log10(n))))
    acov = _autocovariances(x, order_max)
    if acov[0] == 0:
        return 0, np.array([]), 0.0

    # Levinson-Durbin over all orders; AIC = n*log(pred_var) + 2*order
    # (additive constants dropped — they never move the argmin).
    best_aic = n * np.log(acov[0])
    best_order, best = 0, (acov[0], np.array([]))
    phi = np.zeros(0)
    sigma2 = acov[0]
    for p in range(1, order_max + 1):
        if sigma2 <= 0:
            break
        k = (acov[p] - phi @ acov[p - 1:0:-1]) / sigma2
        phi = np.concatenate([phi - k * phi[::-1], [k]])
        sigma2 = sigma2 * (1 - k * k)
        aic = n * np.log(max(sigma2, 1e-300)) + 2 * p
        if aic < best_aic:
            best_aic = aic
            best_order, best = p, (sigma2, phi.copy())

    sigma2, phi = best
    var_pred = sigma2 * n / (n - (best_order + 1))
    return best_order, phi, var_pred


def spectrum0_ar(x: np.ndarray) -> float:
    """coda::spectrum0.ar: AR-estimated spectral density at frequency 0."""
    x = np.asarray(x, float)
    n = len(x)
    if n < 3:
        return 0.0
    # coda's degeneracy check: sd of the residuals of lm(x ~ 1:n) == 0,
    # i.e. the series is EXACTLY linear in its index (constants included).
    z = np.arange(1, n + 1, dtype=float)
    zc = z - z.mean()
    slope = np.dot(zc, x - x.mean()) / np.dot(zc, zc)
    resid = (x - x.mean()) - slope * zc
    if np.allclose(resid, 0.0, atol=1e-12 * max(1.0, np.abs(x).max())):
        return 0.0

    order, phi, var_pred = ar_yw(x)
    denom = (1.0 - phi.sum()) ** 2
    if denom <= 0 or var_pred <= 0:
        return 0.0
    return var_pred / denom


def effective_sample_size(x: np.ndarray) -> float:
    """coda::effectiveSize: N * var(x) / spectrum0 (var with ddof=1)."""
    x = np.asarray(x, float)
    spec = spectrum0_ar(x)
    if spec == 0:
        return 0.0
    return len(x) * x.var(ddof=1) / spec
