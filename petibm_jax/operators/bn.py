"""Truncated-series approximate inverse B_N of the velocity operator.

Reference (src/operators/createbn.cpp:19-96 createBnHead):
``A = I/dt - coeff*L`` and
``B_N = dt*I + sum_{k=2..N} dt^k * coeff^(k-1) * L^(k-1)``.

The reference materializes B_N with repeated parallel SpGEMM; here it is a
closure applying the homogeneous Laplacian (the BC-a0-folded matrix action)
k-1 times — no matrix products, just k-1 fused stencil sweeps, which is the
natural realization on an array machine (SURVEY.md §7 idiomatic mapping).
"""

from __future__ import annotations

import jax

VEL_NAMES = ("u", "v", "w")


def make_bn(laplacian, dt: float, coeff: float, order: int = 1):
    """Return ``bn(g)`` applying B_N to a velocity-space dict ``g``.

    ``laplacian`` is the closure from :func:`make_laplacian`; ``coeff`` is
    ``implicit diffusion coefficient * nu`` (navierstokes.cpp:349-350).
    """
    if order < 1:
        raise ValueError(f"BN order must be >= 1, got {order}")

    def bn(g: dict) -> dict:
        out = jax.tree_util.tree_map(lambda x: dt * x, g)
        term = g
        fac = dt
        for _ in range(2, order + 1):
            term = laplacian(term, None, homogeneous=True)
            fac = fac * dt * coeff
            out = jax.tree_util.tree_map(lambda o, t: o + fac * t, out, term)
        return out

    return bn
