"""Systematic resampling of particles sharded over a mesh axis.

PyTorch counterpart of ``enflows_tpu/parallel/resample.py``. Each rank
holds (n_local, dim) particles and their log weights; the resampler gives
each rank the globally correct systematic resample of its slot range
without funnelling the particles through one rank:

1. global normalization: a max and a sum all-reduced;
2. one shared uniform u0 (drawn from the generator on every rank, rank 0's
   broadcast) defines the grid (u0 + t) / N, t the global slot;
3. each rank's slice of the global weight CDF: its local cumulative
   weights plus its prefix (the ranks' sums, gathered: k scalars);
4. the exchange, two ways with one ancestry:

   * ``gather``: the CDF and the particles ``all_gather``-ed, then a
     search and a row gather. Every rank holds the (n_global, dim)
     particles.
   * ``ring``: a (k - 1)-hop ring of CDF blocks (each hop a
     ``batch_isend_irecv`` of a send and a receive); at each hop a rank
     searches its grid points in the visiting block and keeps the smallest
     global index that reaches them, which is the first-hit search over the
     concatenated CDF; then a second ring of particle blocks, each rank
     copying the rows it needs from the visiting block. Nothing O(n_global)
     is held.

``sharded_systematic_resample`` takes ``ring`` once the gathered particles
would pass ``_GATHER_BYTES_LIMIT`` (256 MB), ``gather`` below it; pass
``method=`` to choose. Both give the same rows.
"""
from __future__ import annotations

import torch

from ..smc import smc as _smc
from .collectives import (all_gather, broadcast_from_zero, pmax, psum,
                          ring_shift)
from .mesh import Axis

_GATHER_BYTES_LIMIT = 256 * 1024 * 1024


def _ring_ancestry(shifted_cdf, pts, n_local: int, axis: Axis):
    """Global ancestry by a ring of CDF blocks: the least global index over
    the visiting blocks whose in-block search hits."""
    k, me = axis.size, axis.index
    n_global = n_local * k
    anc = torch.full(pts.shape, n_global, dtype=torch.int64,
                     device=pts.device)
    block = shifted_cdf
    for s in range(k):
        if s:
            block = ring_shift(block, axis)
        owner = (me + s) % k
        idx = torch.searchsorted(block, pts, side="left")
        cand = owner * n_local + torch.clamp(idx, max=n_local - 1)
        anc = torch.where((idx < n_local) & (cand < anc), cand, anc)
    return torch.clamp(anc, max=n_global - 1)


def _ring_fetch(particles, anc, n_local: int, axis: Axis):
    """Rows ``anc`` (global indices) by a ring of particle blocks."""
    k, me = axis.size, axis.index
    out = torch.empty_like(particles)
    block = particles
    for s in range(k):
        if s:
            block = ring_shift(block, axis)
        rel = anc - ((me + s) % k) * n_local
        hit = (rel >= 0) & (rel < n_local)
        out[hit] = block[rel[hit]]
    return out


def sharded_systematic_resample(generator, log_weights, particles,
                                axis: Axis, method: str | None = None):
    """Systematic resampling of sharded particles
    (``enflows_tpu/parallel/resample.py:119-173``).

    ``generator``: the same on every rank; the resampling uniform is drawn
    from it (``smc.smc._resample_uniform``) on every rank, so every rank's
    generator advances alike, and rank 0's is used. ``log_weights``
    (n_local,), ``particles`` (n_local, dim): this rank's block. Returns
    the resampled (n_local, dim) rows of this rank's slots. ``method``:
    None (by size), "gather" or "ring"."""
    n_local = log_weights.shape[0]
    k = axis.size
    n_global = n_local * k
    dtype, device = particles.dtype, particles.device

    m = pmax(log_weights.max(), axis)
    w = torch.exp(log_weights - m)
    local_sum = w.sum()
    total = psum(local_sum, axis)
    w = w / total

    u0 = broadcast_from_zero(
        _smc._resample_uniform(generator, dtype, device), axis)
    slot0 = axis.index * n_local
    pts = (u0 + slot0 + torch.arange(n_local, dtype=dtype, device=device)) \
        / n_global

    sums = all_gather((local_sum / total).reshape(1), axis)
    prefix = torch.cat([sums.new_zeros(1), torch.cumsum(sums, 0)])
    shifted_cdf = torch.cumsum(w, 0) + prefix[axis.index]

    if method is None:
        nbytes = n_global * particles.shape[-1] * particles.element_size()
        method = "ring" if nbytes > _GATHER_BYTES_LIMIT else "gather"
    if method == "ring":
        anc = _ring_ancestry(shifted_cdf, pts, n_local, axis)
        return _ring_fetch(particles, anc, n_local, axis)
    if method != "gather":
        raise ValueError(f"unknown resample exchange method: {method!r}")
    global_cdf = all_gather(shifted_cdf, axis)
    anc = torch.clamp(torch.searchsorted(global_cdf, pts, side="left"),
                      max=n_global - 1)
    return all_gather(particles, axis)[anc]
