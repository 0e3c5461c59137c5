"""Streaming multichannel FIR filtering.

Oracle: fir_filter (/root/reference/DistantSpeech/beamformer/fixedbeamformer.py:13-48)
— the reference runs an O(samples * taps) per-channel scalar loop per block.

Formulation: the convolution is a block-Toeplitz MATMUL, not a
``lax.conv``.  Grouped small-channel 1-D convolutions lower with per-group
dispatch; expressing each output block as ``window @ T`` with
``T[i, o] = flip(coeffs)[i - o]`` runs the same math as one well-shaped
contraction per channel (the house pattern: see transform.stft's
windowed-DFT matmuls and ops.iir's blocked state-space).
The K-1 tail samples are carried between blocks exactly like the
reference's ``fir_cache``.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp


def _tap_matrix(coeffs: jnp.ndarray, W: int, L: int) -> jnp.ndarray:
    """[C, W, L] block-Toeplitz response: T[c, i, o] = flip(coeffs)[c, i-o]
    (zero outside 0 <= i-o < K), so ``window[o:o+K] . flip(coeffs)`` is the
    column-o matvec.  Built on device (coeffs may be traced); negligible
    next to the matmuls it feeds."""
    K = coeffs.shape[-1]
    fc = jnp.flip(coeffs, axis=-1)
    d = jnp.arange(W)[:, None] - jnp.arange(L)[None, :]
    valid = (d >= 0) & (d < K)
    t = jnp.take(fc, jnp.clip(d, 0, K - 1), axis=-1)  # [C, W, L]
    return jnp.where(valid, t, jnp.zeros_like(t))


def fir_block_taps(coeffs: jnp.ndarray, L: int) -> jnp.ndarray:
    """Precompute the [C, K-1+L, L] block-Toeplitz matrix for
    ``fir_filter_block`` calls with L-sample blocks.  Build this ONCE
    outside any ``lax.scan`` and pass it as the ``coeffs`` argument —
    built inside a scan body the gather is re-executed every step."""
    return _tap_matrix(coeffs, coeffs.shape[-1] - 1 + L, L)


def fir_filter_block(
    cache: jnp.ndarray, x: jnp.ndarray, coeffs: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Causal per-channel FIR of one block.

    cache: [..., C, K-1] carried input tail; x: [..., C, L] block;
    coeffs: [C, K] per-channel taps (tap 0 oldest, like the reference's
    column layout before its flipud) — or the precomputed [C, K-1+L, L]
    matrix from ``fir_block_taps`` (REQUIRED for calls inside a scan body,
    see there).
    Returns (new_cache [..., C, K-1], y [..., C, L]) where
    y[n] = sum_k flip(coeffs)[k] * ext[n + k],  ext = [cache, x].
    """
    L = x.shape[-1]
    if coeffs.ndim == 3:
        T = coeffs.astype(x.dtype)
        K = T.shape[-2] - L + 1
    else:
        K = coeffs.shape[-1]
        T = _tap_matrix(coeffs.astype(x.dtype), K - 1 + L, L)
    ext = jnp.concatenate([cache, x], axis=-1)  # [..., C, K-1+L]
    y = jnp.einsum("...cw,cwo->...co", ext, T, precision="highest")
    return ext[..., -(K - 1):] if K > 1 else cache, y


def fir_filter_offline(x: jnp.ndarray, coeffs: jnp.ndarray, block: int = 128) -> jnp.ndarray:
    """Whole-utterance causal FIR from zero cache: x [..., C, S] -> [..., C, S].

    Internally blocked so each window is built from two adjacent blocks
    (two slices + a concat — no gather materialisation); ``block`` trades
    redundant window FLOPs (W = block + K - 1 MACs per output) against
    matmul shape, and must satisfy block >= K - 1."""
    K = coeffs.shape[-1]
    S = x.shape[-1]
    Lb = block
    while Lb < K - 1:  # window build needs the halo inside one prior block
        Lb *= 2
    nblk = -(-S // Lb)
    ext = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(Lb, nblk * Lb - S)])
    xb = ext.reshape(*x.shape[:-1], nblk + 1, Lb)
    win = jnp.concatenate([xb[..., :-1, Lb - (K - 1):], xb[..., 1:, :]], axis=-1)
    T = _tap_matrix(coeffs.astype(x.dtype), K - 1 + Lb, Lb)
    y = jnp.einsum("...cnw,cwo->...cno", win, T, precision="highest")
    return y.reshape(*x.shape[:-1], nblk * Lb)[..., :S]
