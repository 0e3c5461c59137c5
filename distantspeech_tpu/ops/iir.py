"""Log-depth linear recurrences via ``jax.lax.associative_scan``.

The reference runs its IIR filters sample-by-sample in Python
(Emphasis / FilterDcNotch16, /root/reference/DistantSpeech/adaptivefilter/
feature.py:7-63).  A first-order (or small-state affine) recurrence

    s[n] = A[n] s[n-1] + b[n]

is associative under composition (A2 A1, A2 b1 + b2), so we can evaluate
it in O(log N) depth with full vector-unit utilisation instead of an
N-step scan.  For the short per-block streams of the realtime path the
difference is minor, but for whole-utterance offline processing this is the
difference between serial sample code and a parallel tensor program.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp


def first_order_recurrence(a, b: jnp.ndarray, s0) -> jnp.ndarray:
    """Solve s[n] = a * s[n-1] + b[n] over the last axis, s[-1] = s0.

    a: scalar or [..., N] per-step coefficient; b: [..., N]; s0: scalar or
    [...] initial state.  Returns s: [..., N].
    """
    a_arr = jnp.broadcast_to(jnp.asarray(a, dtype=b.dtype), b.shape)

    def combine(left, right):
        a1, b1 = left
        a2, b2 = right
        return a2 * a1, a2 * b1 + b2

    A, B = jax.lax.associative_scan(combine, (a_arr, b), axis=-1)
    s0 = jnp.asarray(s0, dtype=b.dtype)
    if s0.ndim:
        s0 = s0[..., None]
    return A * s0 + B


def affine_recurrence(A: jnp.ndarray, b: jnp.ndarray, s0: jnp.ndarray) -> jnp.ndarray:
    """Solve s[n] = A[n] @ s[n-1] + b[n] for small state dim k.

    A: [..., N, k, k]; b: [..., N, k]; s0: [..., k].
    Returns s: [..., N, k] (the state after absorbing each step).
    """

    def combine(left, right):
        A1, b1 = left
        A2, b2 = right
        # A2 @ A1 / A2 @ b1 as broadcast-multiply-reduce: a batched k x k
        # dot_general over the huge N axis becomes per-element matmul
        # dispatches (see stats.linalg.matvec).
        A21 = jnp.sum(A2[..., :, :, None] * A1[..., None, :, :], axis=-2)
        b21 = jnp.sum(A2 * b1[..., None, :], axis=-1) + b2
        return A21, b21

    Acum, bcum = jax.lax.associative_scan(combine, (A, b), axis=-3)
    return jnp.sum(Acum * s0[..., None, None, :], axis=-1) + bcum


@lru_cache(maxsize=None)
def _blocked_consts(A_key: tuple, Bv_key: tuple, k: int, n: int):
    """Block state-space constants for s[n] = A s[n-1] + Bv x[n] over an
    n-sample block (float64 numpy):

      Rm [n, n*k] : in-block response  — R[j] = sum_{m<=j} A^{j-m} Bv x[m]
      G  [n, k]   : block charge       — c   = sum_{m} A^{n-1-m} Bv x[m]
      P  [k, k]   : block propagator A^n
      S1 [k, n*k] : initial-state response A^{j+1} s_start per sample j
    """
    import numpy as np

    A = np.asarray(A_key, np.float64).reshape(k, k)
    Bv = np.asarray(Bv_key, np.float64)
    powers = [np.eye(k)]
    for _ in range(n):
        powers.append(powers[-1] @ A)
    pw = np.stack(powers)  # [n+1, k, k], pw[j] = A^j
    v = pw[:n] @ Bv  # [n, k], v[j] = A^j Bv
    j = np.arange(n)[None, :]
    m = np.arange(n)[:, None]
    R = np.where((j >= m)[..., None], v[np.clip(j - m, 0, None)], 0.0)  # [m, j, k]
    Rm = R.reshape(n, n * k)
    G = v[::-1].copy()  # G[m] = A^{n-1-m} Bv
    P = pw[n]
    S1 = np.transpose(pw[1 : n + 1], (2, 0, 1)).reshape(k, n * k)  # [i, j*k+e] = (A^{j+1})[e,i]
    return Rm, G, P, S1


def constant_affine_blocked(A, Bv, x: jnp.ndarray, s0: jnp.ndarray, block: int = 256) -> jnp.ndarray:
    """Solve s[n] = A s[n-1] + Bv x[n] with CONSTANT (A, Bv) over the last
    axis of x, s[-1] = s0; returns the full state sequence [..., N, k].

    Same recurrence as ``affine_recurrence`` with A[n] = A and
    b[n] = Bv * x[n], but evaluated by block state-space decomposition:
    two bulk matmuls per block (in-block Toeplitz response + initial-
    state decay) around a block-level affine recurrence of N//block steps.
    The log-depth sample-level scan materialises [..., N, k, k] tensors at
    every of its log2(N) sweeps, so it moves O(N k^2 log N) bytes through
    device memory; the blocked form is ~2.1e9 MACs at flagship size.
    """
    import numpy as np

    A = np.asarray(A, np.float64)
    Bv = np.asarray(Bv, np.float64)
    k = Bv.shape[0]
    N = x.shape[-1]
    batch = x.shape[:-1]
    key = (tuple(A.ravel()), tuple(Bv.ravel()))

    def run_segment(xseg, s0, n):
        Rm, G, P, S1 = _blocked_consts(key[0], key[1], k, n)
        T = xseg.shape[-1] // n
        xb = xseg.reshape(*batch, T, n)
        dt = x.dtype
        inblock = jnp.matmul(xb, jnp.asarray(Rm, dt), precision="highest")
        c = jnp.matmul(xb, jnp.asarray(G, dt), precision="highest")  # [.., T, k]
        Pb = jnp.broadcast_to(jnp.asarray(P, dt), (*batch, T, k, k))
        m_ends = affine_recurrence(Pb, c, s0)  # [.., T, k]
        m_starts = jnp.concatenate([s0[..., None, :], m_ends[..., :-1, :]], axis=-2)
        decay = jnp.matmul(m_starts, jnp.asarray(S1, dt), precision="highest")
        states = (inblock + decay).reshape(*batch, T * n, k)
        return states, m_ends[..., -1, :]

    n_main = min(block, N)
    n_full = (N // n_main) * n_main
    states, s_end = run_segment(x[..., :n_full], s0, n_main)
    if n_full != N:  # remainder tail as one short block
        tail, _ = run_segment(x[..., n_full:], s_end, N - n_full)
        states = jnp.concatenate([states, tail], axis=-2)
    return states
