"""IDOA spatial speech-presence probability (instantaneous DOA similarity).

Oracle: Idoa.estimate (/root/reference/DistantSpeech/doa/idoa.py:92-160):
recursive RTF estimate B_hat from smoothed cross-spectra, cosine similarity
Delta against a free-field RTF grid Psi, H0/Hd Gaussian/exponential
likelihoods, posterior p per (bin, direction).

Reference quirks kept: the variance recursion's reversed smoothing weights
(var <- (1-avg) var + avg (Delta-mu)^2, idoa.py:146-148), the 0.01 variance
floor, the broadband beta_n from mean mu_Delta over bins 72:128, and the
theta grid built by passing the *index* as degrees (idoa.py:74-76).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from distantspeech_tpu.array.geometry import ArrayGeometry
from distantspeech_tpu.array.steering import steering_vector


@dataclasses.dataclass(frozen=True)
class IdoaConfig:
    n_fft: int = 512
    n_theta: int = 360  # 360 circular / 180 linear (idoa.py:40-43)
    alpha: float = 0.02  # RTF smoothing (idoa.py:121)
    beta: float = 7.6

    @property
    def half_bin(self) -> int:
        return self.n_fft // 2 + 1


def idoa_rtf_grid(cfg: IdoaConfig, geometry: ArrayGeometry) -> np.ndarray:
    """Free-field RTF grid Psi [F, M-1, Theta] (idoa.py:74-76)."""
    angles = np.arange(cfg.n_theta, dtype=np.float64)
    look = np.stack([angles, np.zeros_like(angles)], axis=-1) / 180.0 * np.pi
    a = steering_vector(geometry, look, cfg.n_fft)  # [Theta, F, M]
    psi = a[..., 1:] / a[..., :1]
    return np.moveaxis(psi, 0, -1)  # [F, M-1, Theta]


class IdoaState(NamedTuple):
    Y_smooth: jnp.ndarray  # [..., F]
    Y_xcorr: jnp.ndarray  # [..., F, M-1] complex
    mu_Delta: jnp.ndarray  # [..., F, Theta]
    mu_Delta_h0: jnp.ndarray
    var_Delta_h0: jnp.ndarray
    p: jnp.ndarray  # [..., F, Theta]


def idoa_init(cfg: IdoaConfig, n_mics: int, batch_shape=(), dtype=jnp.float32) -> IdoaState:
    F, Th = cfg.half_bin, cfg.n_theta
    cdtype = jnp.result_type(dtype, jnp.complex64)
    return IdoaState(
        Y_smooth=jnp.zeros((*batch_shape, F), dtype=dtype),
        Y_xcorr=jnp.zeros((*batch_shape, F, n_mics - 1), dtype=cdtype),
        mu_Delta=jnp.zeros((*batch_shape, F, Th), dtype=dtype),
        mu_Delta_h0=jnp.zeros((*batch_shape, F, Th), dtype=dtype),
        var_Delta_h0=jnp.full((*batch_shape, F, Th), 0.1, dtype=dtype),
        p=jnp.zeros((*batch_shape, F, Th), dtype=dtype),
    )


def idoa_step(
    cfg: IdoaConfig, psi: jnp.ndarray, psi_norm: jnp.ndarray, state: IdoaState, X: jnp.ndarray
) -> Tuple[IdoaState, jnp.ndarray]:
    """One frame.  psi: [F, M-1, Theta]; psi_norm: [F, Theta] = ||psi||;
    X: [..., F, M] complex spectra.  Returns (state, p [..., F, Theta])."""
    a = cfg.alpha
    Y_curr = jnp.abs(X[..., 0] * jnp.conj(X[..., 0]))
    Y_xcorr_curr = X[..., 1:] * jnp.conj(X[..., :1])

    Y_smooth = (1.0 - a) * state.Y_smooth + a * Y_curr
    Y_xcorr = (1.0 - a) * state.Y_xcorr + a * Y_xcorr_curr
    B_hat = Y_xcorr / Y_smooth[..., None].astype(Y_xcorr.dtype)  # [..., F, M-1]

    den = psi_norm * jnp.linalg.norm(B_hat, axis=-1)[..., None]  # [..., F, Theta]
    Delta = jnp.real(jnp.einsum("fmt,...fm->...ft", jnp.conj(psi).astype(B_hat.dtype), B_hat,
                                precision="highest")) / (den + 1e-6)

    avg = (1.0 - state.p) * 0.98
    mu_Delta = avg * state.mu_Delta + (1.0 - avg) * Delta

    avg0 = 0.998 + (1.0 - 0.998) * state.p
    mu_h0 = avg0 * state.mu_Delta_h0 + (1.0 - avg0) * Delta
    var_h0 = jnp.maximum((1.0 - avg0) * state.var_Delta_h0 + avg0 * (Delta - mu_h0) ** 2, 0.01)

    beta_n = 1.0 / (1.0 - jnp.mean(mu_Delta[..., 72:128, :], axis=-2))  # [..., Theta]

    p_h0 = jnp.exp(-((Delta - mu_h0) ** 2) / (2.0 * 0.5**2))
    p_hd = beta_n[..., None, :] * jnp.exp(cfg.beta * (Delta - 1.0))
    Lam = p_hd / (p_h0 + 1e-6)
    p = Lam / (1.0 + Lam)

    return IdoaState(Y_smooth=Y_smooth, Y_xcorr=Y_xcorr, mu_Delta=mu_Delta,
                     mu_Delta_h0=mu_h0, var_Delta_h0=var_h0, p=p), p


def idoa_run(cfg: IdoaConfig, geometry: ArrayGeometry, X_tf: jnp.ndarray) -> jnp.ndarray:
    """Scan over frames.  X_tf: [T, ..., F, M] -> p [T, ..., F, Theta]."""
    psi = jnp.asarray(idoa_rtf_grid(cfg, geometry))
    psi_norm = jnp.linalg.norm(psi, axis=-2).real.astype(X_tf.real.dtype)  # [F, Theta]
    state = idoa_init(cfg, geometry.n_mics, batch_shape=X_tf.shape[1:-2], dtype=X_tf.real.dtype)
    _, p = jax.lax.scan(lambda s, x: idoa_step(cfg, psi, psi_norm, s, x), state, X_tf)
    return p
