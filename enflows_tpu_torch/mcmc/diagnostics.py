"""MCMC diagnostics: effective sample size and split-R-hat.

Counterpart of ``enflows_tpu/mcmc/diagnostics.py``, with the same math: numpy
in, numpy out (the inverse normal CDF from scipy). ESS follows the Geyer
initial-monotone-sequence estimator on FFT autocovariances (the Stan/ArviZ
standard); R-hat is the split-chain potential scale reduction factor.
`rank_normalized_rhat` / `bulk_ess` / `tail_ess` implement the full Vehtari
et al. 2021 recipe (rank-normalize, fold for scale mismatches, indicator
quantities for tail quantiles).

Shapes: samples are (chains, steps) per scalar quantity, or
(chains, steps, dim) handled per-dimension. Torch tensors are accepted and
read to the host.
"""
from __future__ import annotations

import numpy as np
from scipy.special import ndtri as _ndtri


def _host(a, dtype=None) -> np.ndarray:
    """``a`` as a numpy array (a torch tensor is copied to the host)."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def _autocov_fft(x: np.ndarray) -> np.ndarray:
    """Autocovariance per chain via FFT; x (chains, steps)."""
    n = x.shape[1]
    xc = x - x.mean(axis=1, keepdims=True)
    m = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, m, axis=1)
    acov = np.fft.irfft(f * np.conj(f), m, axis=1)[:, :n].real
    return acov / n


def ess(samples) -> float:
    """Bulk ESS of a (chains, steps) scalar chain set."""
    x = _host(samples, np.float64)
    nchains, nsteps = x.shape
    acov = _autocov_fft(x)                       # (chains, steps)
    chain_var = acov[:, 0] * nsteps / (nsteps - 1.0)
    mean_var = np.mean(chain_var)
    var_plus = mean_var * (nsteps - 1.0) / nsteps
    if nchains > 1:
        var_plus += np.var(x.mean(axis=1), ddof=1)
    if var_plus <= 0.0:        # constant draws (e.g. extreme-quantile
        return float(nchains * nsteps)   # indicators): no autocorrelation

    rho = 1.0 - (mean_var - np.mean(acov, axis=0)) / var_plus   # (steps,)
    # Geyer: sum consecutive pairs while positive, enforce monotonicity.
    max_t = nsteps - (nsteps % 2)
    pair = rho[:max_t].reshape(-1, 2).sum(axis=1)
    # truncate at first negative pair
    neg = np.nonzero(pair < 0)[0]
    cutoff = neg[0] if neg.size else pair.size
    pair = pair[:cutoff]
    # initial monotone sequence
    pair = np.minimum.accumulate(pair) if pair.size else pair
    tau = -1.0 + 2.0 * pair.sum()
    tau = max(tau, 1.0 / np.log10(nsteps + 10.0))  # guard
    return float(nchains * nsteps / tau)


def ess_per_dim(samples) -> np.ndarray:
    """ESS per dimension for samples (chains, steps, dim)."""
    x = _host(samples)
    return np.array([ess(x[..., d]) for d in range(x.shape[-1])])


def split_rhat(samples) -> float:
    """Split-chain R-hat of (chains, steps) draws."""
    x = _host(samples, np.float64)
    nchains, nsteps = x.shape
    half = nsteps // 2
    splits = np.concatenate([x[:, :half], x[:, half:2 * half]], axis=0)
    m, n = splits.shape
    chain_means = splits.mean(axis=1)
    b = n * np.var(chain_means, ddof=1)
    w = np.mean(np.var(splits, axis=1, ddof=1))
    var_plus = (n - 1.0) / n * w + b / n
    return float(np.sqrt(var_plus / w))


def split_rhat_per_dim(samples) -> np.ndarray:
    x = _host(samples)
    return np.array([split_rhat(x[..., d]) for d in range(x.shape[-1])])


def _rank_normalize(x: np.ndarray) -> np.ndarray:
    """Fractional-rank normal scores z = Phi^-1((r - 3/8) / (S + 1/4)).

    Average ranks over ties (Vehtari et al. 2021 §3); x is ranked over ALL
    chains/draws jointly, preserving shape.
    """
    flat = x.reshape(-1)
    order = np.argsort(flat, kind="stable")
    ranks = np.empty_like(flat, dtype=np.float64)
    ranks[order] = np.arange(1, flat.size + 1, dtype=np.float64)
    # average tied ranks
    sorted_vals = flat[order]
    is_new = np.concatenate([[True], sorted_vals[1:] != sorted_vals[:-1]])
    group = np.cumsum(is_new) - 1
    gsum = np.bincount(group, weights=np.arange(1, flat.size + 1))
    gcnt = np.bincount(group)
    avg = (gsum / gcnt)[group]
    ranks[order] = avg
    z = _ndtri((ranks - 3.0 / 8.0) / (flat.size + 0.25))
    return z.reshape(x.shape)


def rank_normalized_rhat(samples) -> float:
    """Rank-normalized split-R-hat (Vehtari et al. 2021).

    max of split-R-hat on the rank-normal scores of the draws (bulk:
    catches location mismatches) and of the folded draws
    |x - median| (catches scale/tail mismatches classic R-hat misses).
    samples: (chains, steps).
    """
    x = _host(samples, np.float64)
    bulk = split_rhat(_rank_normalize(x))
    folded = split_rhat(_rank_normalize(np.abs(x - np.median(x))))
    return float(max(bulk, folded))


def rank_normalized_rhat_per_dim(samples) -> np.ndarray:
    x = _host(samples)
    return np.array([rank_normalized_rhat(x[..., d])
                     for d in range(x.shape[-1])])


def bulk_ess(samples) -> float:
    """Bulk ESS: Geyer ESS of the rank-normal scores (chains, steps)."""
    return ess(_rank_normalize(_host(samples, np.float64)))


def tail_ess(samples) -> float:
    """Tail ESS: min ESS of the 5%/95%-quantile indicator quantities.

    Measures how reliably the chain estimates tail quantiles — sticky
    tails (e.g. funnel necks) show tail_ess << bulk_ess. samples:
    (chains, steps).
    """
    x = _host(samples, np.float64)
    out = []
    for q in (0.05, 0.95):
        ind = (x <= np.quantile(x, q)).astype(np.float64)
        out.append(ess(ind))
    return float(min(out))


def bfmi(energies) -> float:
    """Bayesian fraction of missing information (Betancourt 2016).

    energies: (chains, steps) per-transition total Hamiltonian energies at
    the accepted states (``HMCInfo.energy`` / ``NUTSInfo.energy`` /
    ``ChEESInfo.energy`` — potential *plus* kinetic). Values << 0.3
    indicate the momentum resampling can't explore the energy marginal —
    heavy tails the mass matrix can't fix.
    """
    e = _host(energies, np.float64)
    de = np.diff(e, axis=1)
    return float(np.mean(de ** 2) / np.var(e))


def pareto_khat(log_weights) -> float:
    """PSIS Pareto k-hat of importance log-weights (Vehtari, Simpson,
    Gelman, Yao, Gabry 2024 "Pareto smoothed importance sampling";
    GPD tail fit via the Zhang & Stephens 2009 profile-posterior
    estimator, the arviz/loo reference method).

    The standard variational-fit quality diagnostic (Yao et al. 2018
    "Yes, but did it work?"): with w = p~(z)/q(z) for z ~ q,
    k-hat <= 0.7 means the q-to-p importance correction has finite
    enough variance to trust the fit; k-hat > 0.7 flags a transport
    that is missing mass — mode collapse included, which ELBO values
    alone cannot reveal without a reference. Used by ``infer``'s
    precondition escalation.
    """
    lw = _host(log_weights, np.float64).reshape(-1)
    lw = lw[np.isfinite(lw)]
    S = lw.size
    if S < 20:
        return float("inf")
    lw = lw - lw.max()
    M = int(min(0.2 * S, 3.0 * np.sqrt(S)))
    tail = np.sort(lw)[-M:]
    cutoff = np.sort(lw)[-M - 1]
    x = np.exp(tail) - np.exp(cutoff)          # exceedances, ascending
    x = x[x > 0.0]
    n = x.size
    if n < 5:
        return float("inf")
    # Zhang & Stephens profile posterior over b = -xi/sigma (the arviz
    # _gpdfit formulation, signs and all).
    prior_bs = 3.0
    prior_k = 10.0
    m_grid = 30 + int(np.sqrt(n))
    j = np.arange(1, m_grid + 1, dtype=np.float64)
    b = 1.0 - np.sqrt(m_grid / (j - 0.5))
    b = b / (prior_bs * x[int(n / 4.0 + 0.5) - 1]) + 1.0 / x[-1]
    k_j = np.mean(np.log1p(-b[:, None] * x[None, :]), axis=1)
    l_j = n * (np.log(-(b / k_j)) - k_j - 1.0)
    w_j = 1.0 / np.sum(np.exp(l_j[None, :] - l_j[:, None]), axis=1)
    b_post = np.sum(b * w_j)
    k = float(np.mean(np.log1p(-b_post * x)))
    # Weakly-informative shrinkage (arviz): stabilizes small tails.
    return float((k * n + prior_k * 0.5) / (n + prior_k))
