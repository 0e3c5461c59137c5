"""Recursive spectral statistics — one frame at a time, batched over bins.

Each function is a pure step usable directly inside ``lax.scan`` bodies.
Replaces the reference's per-bin Python loops (beamformer.update_psd
beamformer.py:158-179, update_csd :182-215, get_covariance_yy :294-304,
adaptivebeamformer.py:86-88 rank-1 recursion) with broadcasted tensor ops.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def update_psd(Z: jnp.ndarray, Pxii: jnp.ndarray, alpha: float = 0.8) -> jnp.ndarray:
    """Recursive auto-PSD: P <- alpha P + (1-alpha) |Z|^2.

    Z: complex [..., F, C] (or any shape); Pxii: real, same shape.
    """
    return alpha * Pxii + (1.0 - alpha) * jnp.real(Z * jnp.conj(Z))


def _pair_indices(n_ch: int):
    """Upper-triangle (i<j) channel pairs in the reference's ordering."""
    iu = np.triu_indices(n_ch, k=1)
    return iu[0], iu[1]


def update_csd(Z: jnp.ndarray, Pxij: jnp.ndarray, alpha: float = 0.8) -> jnp.ndarray:
    """Recursive cross-PSD over channel pairs.

    Z: [..., F, C] complex; Pxij: [..., F, C*(C-1)//2] complex ordered
    (0,1),(0,2),...,(C-2,C-1) exactly like beamformer.update_csd.
    """
    i_idx, j_idx = _pair_indices(Z.shape[-1])
    cur = Z[..., i_idx] * jnp.conj(Z[..., j_idx])
    return alpha * Pxij + (1.0 - alpha) * cur


def rank1_update(R: jnp.ndarray, z: jnp.ndarray, alpha: float) -> jnp.ndarray:
    """Recursive spatial covariance: R <- alpha R + (1-alpha) z z^H.

    R: [..., F, C, C]; z: [..., F, C].  The outer product batches over bins —
    a small broadcasted multiply the compiler fuses with the decay; no
    per-bin loop, no matmul needed for a rank-1 term.
    """
    outer = z[..., :, None] * jnp.conj(z)[..., None, :]
    return alpha * R + (1.0 - alpha) * outer


def hermitize(R: jnp.ndarray) -> jnp.ndarray:
    """Force Hermitian symmetry (numerical guard, cf. mcspp.py:210)."""
    return 0.5 * (R + jnp.swapaxes(jnp.conj(R), -1, -2))
