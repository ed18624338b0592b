"""Batched tridiagonal solve via parallel cyclic reduction (PCR).

The multigrid line smoother solves one tridiagonal system per grid line
per sweep (linalg/mg.py).  PCR eliminates the +-k couplings in
ceil(log2(n)) fully-vectorized passes over the whole batch, in place of
the sequential Thomas recurrence (n dependent steps of tiny work).  The
smoother's default is ``lax.linalg.tridiagonal_solve``, which measured
faster on both the CPU and the GPU (mg.py); PCR serves the dtypes that
solver lacks (bf16 V-cycles) and is the tests' second implementation.

For the smoother's systems (finite-volume Poisson lines) the matrix is
strictly diagonally dominant — diag = sum of all-direction couplings,
off-diagonals = one direction's couplings — so PCR is numerically stable
in f32.

Solves a_i x_{i-1} + b_i x_i + c_i x_{i+1} = d_i along the LAST axis;
any leading batch axes.  a[..., 0] and c[..., n-1] are ignored (set to 0).
"""

from __future__ import annotations

import math

import jax.numpy as jnp


def _shift(arr, k: int, fill: float = 0.0):
    """arr shifted by +k along the last axis (value at index i becomes the
    old value at i-k), vacated entries filled with ``fill``."""
    n = arr.shape[-1]
    pad = [(0, 0)] * (arr.ndim - 1)
    if k >= 0:
        out = jnp.pad(arr[..., : n - k], pad + [(k, 0)])
    else:
        out = jnp.pad(arr[..., -k:], pad + [(0, -k)])
    if fill != 0.0:
        idx = jnp.arange(n)
        mask = idx < k if k >= 0 else idx >= n + k
        out = jnp.where(mask, jnp.asarray(fill, arr.dtype), out)
    return out


def tridiag_solve_pcr(a, b, c, d):
    """Solve the batched tridiagonal systems (last axis) with PCR.

    PCR invariant: after m passes row i couples only to rows i +- 2^m,
    with a_i = 0 for i < 2^m and c_i = 0 for i >= n - 2^m (maintained
    automatically from a[...,0] = c[...,n-1] = 0), so after
    ceil(log2(n)) passes every equation is diagonal: x_i = d_i / b_i.
    Out-of-range neighbor diagonals read as 1 so the elimination factors
    vanish cleanly (-0/1) instead of dividing by zero.
    """
    n = a.shape[-1]
    if n == 1:
        return d / b
    a = a.at[..., 0].set(0.0)
    c = c.at[..., n - 1].set(0.0)
    k = 1
    for _ in range(math.ceil(math.log2(n))):
        alpha = -a / _shift(b, k, fill=1.0)
        beta = -c / _shift(b, -k, fill=1.0)
        a, b, c, d = (
            alpha * _shift(a, k),
            b + alpha * _shift(c, k) + beta * _shift(a, -k),
            beta * _shift(c, -k),
            d + alpha * _shift(d, k) + beta * _shift(d, -k),
        )
        k *= 2
    return d / b
