"""Tiny fixed-size linear algebra for the 6-DoF Gauss-Newton systems.

jnp.linalg.{solve,det} on small matrices lower to generic LU routines; the
normal equations here are symmetric (H = J^T J), so an unrolled 6x6
Cholesky (21 scalar ops + two triangular substitutions) does the job inside
the aligner's while_loop (its speed against jnp.linalg is not measured on
the H100) and doubles as the observability check (positive pivots == full rank,
replacing the reference's Eigen rank() test at RegisterPhotoICP.h:4682).
"""

from __future__ import annotations

import jax.numpy as jnp

N = 6


def cholesky6(H: jnp.ndarray):
    """Unrolled Cholesky of a symmetric 6x6. Returns (L, ok).

    ok is False when any pivot is non-positive or non-finite (H not SPD —
    the ill-posed case). No exceptions are raised; L contains garbage where
    ok is False and must be gated by the caller.
    """
    L = [[jnp.zeros(H.shape[:-2], H.dtype) for _ in range(N)] for _ in range(N)]
    ok = jnp.ones(H.shape[:-2], bool)
    eps = jnp.asarray(1e-30, H.dtype)
    for j in range(N):
        s = H[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        ok = ok & (s > 0) & jnp.isfinite(s)
        d = jnp.sqrt(jnp.maximum(s, eps))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, N):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    return L, ok


def solve6_sym(H: jnp.ndarray, b: jnp.ndarray):
    """Solve H x = b for symmetric positive-definite H. Returns (x, ok)."""
    L, ok = cholesky6(H)
    # forward substitution L y = b
    y = [None] * N
    for i in range(N):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # back substitution L^T x = y
    x = [None] * N
    for i in reversed(range(N)):
        s = y[i]
        for k in range(i + 1, N):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1), ok


def spd_well_posed(H: jnp.ndarray, lam) -> jnp.ndarray:
    """Observability guard: Cholesky of H + lam*diag(H) succeeds
    (reference rank check, RegisterPhotoICP.h:4682)."""
    # lam*diag(H) as a matrix: elementwise eye-mask keeps only the diagonal
    Hd = H + lam * (jnp.eye(N, dtype=H.dtype) * H)
    _, ok = cholesky6(Hd)
    return ok & jnp.all(jnp.isfinite(H), axis=(-2, -1))


def logdet6_sym(H: jnp.ndarray):
    """log|H| via Cholesky (for the Kerl entropy formula)."""
    L, ok = cholesky6(H)
    diag = jnp.stack([L[i][i] for i in range(N)], axis=-1)
    return 2.0 * jnp.sum(jnp.log(diag), axis=-1), ok


def inv6_sym(H: jnp.ndarray):
    """Inverse of symmetric 6x6 via 6 solves (columns of identity)."""
    cols = []
    ok = None
    for i in range(N):
        e = jnp.zeros(H.shape[:-1], H.dtype).at[..., i].set(1.0)
        x, ok = solve6_sym(H, e)
        cols.append(x)
    return jnp.stack(cols, axis=-1), ok
