"""Beamformer weight formulas, batched over frequency bins.

All formulas act on ``[..., F, C]`` steering vectors and ``[..., F, C, C]``
spatial matrices in one shot.  Oracle semantics: beamformer.getweights
(/root/reference/DistantSpeech/beamformer/beamformer.py:306-336),
compute_mvdr_weight (:133-155), compute_pmwf_weight (:100-130),
blind_analytic_normalization (:34-63), get_gev_vector (:79-97).
"""

from __future__ import annotations

import jax.numpy as jnp

from distantspeech_tpu.stats.linalg import matvec, trace_mm


def diag_load_inv(R: jnp.ndarray, diag: float = 1e-3) -> jnp.ndarray:
    """inv(R + diag * I) batched over leading axes (diagonal loading guard)."""
    eye = jnp.eye(R.shape[-1], dtype=R.dtype)
    return jnp.linalg.inv(R + diag * eye)


def mvdr_weights(steer: jnp.ndarray, Rvv_inv: jnp.ndarray) -> jnp.ndarray:
    """w = Rvv^-1 a / (a^H Rvv^-1 a).

    steer: [..., F, C]; Rvv_inv: [..., F, C, C] -> w: [..., F, C].
    """
    # multiply-reduce: tiny batched contractions become per-bin matmul
    # dispatches (see stats.linalg.matvec) and this runs per frame inside
    # mvdr scans
    num = matvec(Rvv_inv, steer)
    den = jnp.sum(jnp.conj(steer) * num, axis=-1)
    return num / den[..., None]


def ds_weights(steer: jnp.ndarray) -> jnp.ndarray:
    """Delay-and-sum: w = a / C."""
    return steer / steer.shape[-1]


def pmwf_weights(xi: jnp.ndarray, Rxx: jnp.ndarray, Rvv_inv: jnp.ndarray, beta: float = 1.0) -> jnp.ndarray:
    """Parameterised multichannel Wiener filter, reference channel 0.

    w = (Rvv^-1 Rxx u) / (beta + xi);  xi: [..., F] prior SNR;
    Rxx, Rvv_inv: [..., F, C, C] -> w: [..., F, C].
    Cf. compute_pmwf_weight (beamformer.py:100-130).
    """
    num = matvec(Rvv_inv, Rxx[..., :, 0])
    return num / (beta + xi)[..., None]


def tfgsc_weights(Rvv_inv: jnp.ndarray, Ryy: jnp.ndarray) -> jnp.ndarray:
    """Frequency-domain transfer-function GSC weights (Chen, "Noncausal
    (Frequency-Domain) Optimal Filters").

    w = (Rvv^-1 Ryy - I) u / (tr(Rvv^-1 Ryy) - C), reference channel 0.
    Cf. beamformer.getweights 'TFGSC' branch (beamformer.py:327-333).
    """
    C = Ryy.shape[-1]
    num = matvec(Rvv_inv, Ryy[..., :, 0]) - jnp.eye(C, dtype=Ryy.dtype)[:, 0]
    den = trace_mm(Rvv_inv, Ryy) - C
    return num / den[..., None]


def blind_analytic_normalization(w: jnp.ndarray, Rvv: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    """BAN distortion-reduction rescale of beamformer weights.

    w: [..., C]; Rvv: [..., C, C].  Cf. beamformer.py:34-63.
    """
    num = jnp.einsum("...a,...ab,...bc,...c->...", jnp.conj(w), Rvv, Rvv, w, precision="highest")
    num = jnp.abs(jnp.sqrt(num))
    den = jnp.abs(jnp.einsum("...a,...ab,...b->...", jnp.conj(w), Rvv, w, precision="highest"))
    return w * (num / (den + eps))[..., None]


def gev_weights(Rxx: jnp.ndarray, Rvv: jnp.ndarray) -> jnp.ndarray:
    """Generalised-eigenvector (max-SNR) beamformer.

    Solves Rxx v = lambda Rvv v for the principal eigenvector, batched over
    bins, via the Cholesky whitening reduction to an ordinary Hermitian
    eigenproblem (jit-friendly; no scipy.eigh loop as in beamformer.py:79-97).
    """
    L = jnp.linalg.cholesky(Rvv)
    Li = jnp.linalg.inv(L)
    # whitened matrix: Li Rxx Li^H
    A = jnp.matmul(jnp.matmul(Li, Rxx, precision="highest"), jnp.swapaxes(jnp.conj(Li), -1, -2),
                   precision="highest")
    _, vecs = jnp.linalg.eigh(A)
    v = vecs[..., :, -1]
    # un-whiten: w = Li^H v
    return jnp.einsum("...ji,...j->...i", jnp.conj(Li), v, precision="highest")


def phase_correction(w: jnp.ndarray) -> jnp.ndarray:
    """Align beamformer-vector phase across frequency (reference
    ``phase_correction``, beamformer.py:66-77).

    The oracle is a serial recursion over bins: each bin is rotated so its
    inner product with the *already corrected* previous bin is real-positive.
    Because each correction is a pure unit phase, the recursion telescopes to
    a cumulative sum of the raw pairwise phases — one vectorised ``cumsum``
    instead of a bin loop.

    w: [..., F, C] -> phase-corrected [..., F, C].
    """
    pair = jnp.sum(w[..., 1:, :] * jnp.conj(w[..., :-1, :]), axis=-1)
    phi = jnp.angle(pair)
    theta = jnp.cumsum(phi, axis=-1)
    theta = jnp.concatenate([jnp.zeros_like(theta[..., :1]), theta], axis=-1)
    return w * jnp.exp(-1j * theta)[..., None]


def pca_steering(Rxx: jnp.ndarray) -> jnp.ndarray:
    """Principal eigenvector of the spatial covariance, phase-normalised to
    channel 0 (reference ``steering``, beamformer.py:10-31)."""
    _, vecs = jnp.linalg.eigh(Rxx)
    v = vecs[..., :, -1]
    phase = jnp.exp(1j * jnp.angle(v[..., :1]))
    return v / phase
