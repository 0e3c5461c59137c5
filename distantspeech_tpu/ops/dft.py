"""Small real-FFT as matmuls.

The sizes this library uses are small (256-2048 points, called once per
frame inside ``lax.scan``).  An N-point rDFT is a
``[..., N] @ [N, 2(N/2+1)]`` real matmul — O(N^2) flops instead of
O(N log N), but one well-shaped matmul that fuses with its neighbours, and
the matrices (<= 2048 x 2050 f32 = 16 MB at the cap) are compile-time
constants.  Whether cuFFT beats it on the GPU is not measured yet.

``rdft``/``irdft`` are drop-in (axis=-1) replacements for ``jnp.fft.rfft`` /
``jnp.fft.irfft`` that fall back to the FFT above ``MATMUL_MAX_N``.
precision='highest' keeps f32 error ~1e-7 (a reduced-precision pass —
bf16 or TF32 — is ~1e-3 and would break reference parity).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

MATMUL_MAX_N = 2048


@lru_cache(maxsize=None)
def _fwd_mat(n: int) -> np.ndarray:
    k = np.arange(n // 2 + 1)[None, :]
    t = np.arange(n)[:, None]
    ang = -2.0 * np.pi * t * k / n
    return np.concatenate([np.cos(ang), np.sin(ang)], axis=1)  # [n, 2F]


@lru_cache(maxsize=None)
def _inv_mat(n: int) -> np.ndarray:
    F = n // 2 + 1
    k = np.arange(F)[:, None]
    t = np.arange(n)[None, :]
    ang = 2.0 * np.pi * k * t / n
    scale = np.full((F, 1), 2.0)
    scale[0] = 1.0
    if n % 2 == 0:
        scale[-1] = 1.0
    A = np.cos(ang) * scale / n
    B = -np.sin(ang) * scale / n
    return np.concatenate([A, B], axis=0)  # [2F, n]


def rdft(x: jnp.ndarray, n: int | None = None, axis: int = -1) -> jnp.ndarray:
    """``jnp.fft.rfft(x, n=n, axis=-1)`` as one matmul (small n)."""
    assert axis in (-1, x.ndim - 1), "rdft only supports the last axis"
    L = x.shape[-1]
    if n is None:
        n = L
    if n > MATMUL_MAX_N:
        return jnp.fft.rfft(x, n=n, axis=-1)
    if L < n:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, n - L)])
    elif L > n:
        x = x[..., :n]
    CS = jnp.asarray(_fwd_mat(n), dtype=x.dtype)
    Y = jnp.matmul(x, CS, precision="highest")
    F = n // 2 + 1
    return jax.lax.complex(Y[..., :F], Y[..., F:])


def irdft(X: jnp.ndarray, n: int | None = None, axis: int = -1) -> jnp.ndarray:
    """``jnp.fft.irfft(X, n=n, axis=-1)`` as one matmul (small n)."""
    assert axis in (-1, X.ndim - 1), "irdft only supports the last axis"
    if n is None:
        n = 2 * (X.shape[-1] - 1)
    if n > MATMUL_MAX_N or X.shape[-1] != n // 2 + 1:
        return jnp.fft.irfft(X, n=n, axis=-1)
    Xr = jnp.real(X)
    AB = jnp.asarray(_inv_mat(n), dtype=Xr.dtype)
    Yri = jnp.concatenate([Xr, jnp.imag(X)], axis=-1)
    return jnp.matmul(Yri, AB, precision="highest")
