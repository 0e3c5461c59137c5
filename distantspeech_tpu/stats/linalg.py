"""Batched small-matrix inverse without XLA's serial LU path.

``jnp.linalg.inv`` lowers to a blocked LU with pivoting and data-dependent
control flow, latency-bound for many small matrices.  For the
diagonally-loaded Hermitian matrices this framework inverts (covariances +
eps*I), an **unrolled Gauss-Jordan elimination without pivoting** is
numerically safe and runs as M fully-vectorised elementwise steps over the
batch — fusible elementwise work, no loops in the lowered program.
"""

from __future__ import annotations

import jax.numpy as jnp


def matvec(A: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Batched ``A @ x`` for tiny trailing dims as broadcast-multiply-reduce.

    A: [..., M, N]; x: [..., N] -> [..., M].  A batched dot_general whose
    contraction is tiny (M, N <= ~32) becomes many tiny matmuls that
    cannot fuse with the surrounding step; this elementwise form fuses.
    Mixed real/complex operands broadcast-promote, so no .astype is needed
    at call sites.
    """
    return jnp.sum(A * x[..., None, :], axis=-1)


def vecmat(x: jnp.ndarray, A: jnp.ndarray) -> jnp.ndarray:
    """Batched ``x^T A`` (x: [..., M]; A: [..., M, N] -> [..., N]), same
    rationale as :func:`matvec`."""
    return jnp.sum(x[..., :, None] * A, axis=-2)


def trace_mm(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """``tr(A @ B) = sum_ij A_ij B_ji`` without forming the product."""
    return jnp.sum(A * jnp.swapaxes(B, -1, -2), axis=(-2, -1))


def gauss_jordan_inv(A: jnp.ndarray) -> jnp.ndarray:
    """Inverse of well-conditioned (diag-loaded) matrices, batched.

    A: [..., M, M] (real or complex).  Returns A^-1 with an unrolled
    elimination — intended for small static M (<= ~16).
    """
    M = A.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(M, dtype=A.dtype), A.shape)
    work = jnp.concatenate([A, eye], axis=-1)  # [..., M, 2M]
    for k in range(M):
        pivot_row = work[..., k, :] / work[..., k, k][..., None]  # [..., 2M]
        col = work[..., :, k]  # [..., M]
        elim = work - col[..., :, None] * pivot_row[..., None, :]
        work = elim.at[..., k, :].set(pivot_row)
    return work[..., :, M:]


def diag_loaded_inv(A: jnp.ndarray, diag: float) -> jnp.ndarray:
    """inv(A + diag * I) via the unrolled elimination."""
    eye = jnp.eye(A.shape[-1], dtype=A.dtype)
    return gauss_jordan_inv(A + diag * eye)


def ldl_solve(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """x = A^-1 b for hermitian positive-definite A, batched, unrolled.

    A: [..., M, M] (hermitian, e.g. diag-loaded covariance); b: [..., M].
    Unrolled LDL^H factorisation + two triangular solves: ~M^3/6 complex
    multiplies versus ~M^3 for the full Gauss-Jordan inverse, no sqrt, and
    only elementwise batched ops in the lowered program.  When just A^-1 b
    is needed (MVDR weights against a steering vector) this is ~4x cheaper
    than materialising the inverse.
    """
    M = A.shape[-1]
    L = [[None] * M for _ in range(M)]
    D = [None] * M
    Dinv = [None] * M
    for j in range(M):
        d = A[..., j, j]
        for k in range(j):
            d = d - (L[j][k] * jnp.conj(L[j][k])) * D[k]
        D[j] = d
        Dinv[j] = 1.0 / d
        for i in range(j + 1, M):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * jnp.conj(L[j][k]) * D[k]
            L[i][j] = s * Dinv[j]
    # forward: L v = b (unit diagonal)
    v = [None] * M
    for i in range(M):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * v[k]
        v[i] = s
    # diagonal + backward: L^H x = v / D
    x = [None] * M
    for i in range(M - 1, -1, -1):
        s = v[i] * Dinv[i]
        for k in range(i + 1, M):
            s = s - jnp.conj(L[k][i]) * x[k]
        x[i] = s
    return jnp.stack(x, axis=-1)
