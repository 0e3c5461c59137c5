"""SRP-PHAT steered-response-power DOA.

Oracle: srp.compute_angle_spectrum (/root/reference/DistantSpeech/doa/srp.py:17-53).
The reference loops 360 steering directions x frames in Python; here the
whole angle spectrum is one batched contraction.  Key restructuring: the
PHAT normaliser |a* y| equals |y| (|a| = 1), so the per-angle normalisation
of the reference collapses to ONE whitening of the spectrum followed by a
[Theta, F, M] x [T, F, M] einsum — the hot op is one batched complex
matmul instead of 360 x T Python iterations.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from distantspeech_tpu.array.geometry import ArrayGeometry
from distantspeech_tpu.array.steering import steering_vector
from distantspeech_tpu.noise.mcra import McraConfig, mcra_run
from distantspeech_tpu.transform import StftConfig, analysis


@dataclasses.dataclass(frozen=True)
class SrpConfig:
    n_fft: int = 256
    resolution: int = 1  # degrees

    @property
    def stft(self) -> StftConfig:
        return StftConfig(self.n_fft, self.n_fft // 2)

    @property
    def mcra(self) -> McraConfig:
        return McraConfig(nfft=self.n_fft, L=65)  # srp.py:13-15


def srp_steering_grid(cfg: SrpConfig, geometry: ArrayGeometry) -> np.ndarray:
    """Free-field steering vectors for 0..359 deg: [Theta, F, M] complex."""
    angles = np.arange(0, 360, cfg.resolution, dtype=np.float64)
    look = np.stack([angles, np.zeros_like(angles)], axis=-1) / 180.0 * np.pi
    return steering_vector(geometry, look, cfg.n_fft)  # [Theta, F, M]


def srp_angle_spectrum(
    Y_tfm: jnp.ndarray, grid: jnp.ndarray, phat: bool = True
) -> jnp.ndarray:
    """Angle spectrum of a spectrogram.

    Y_tfm: [T, ..., F, M]; grid: [Theta, F, M].
    Returns [T, ..., Theta]: sum_f |sum_m a*_theta y_phat| (srp.py:45-52).
    """
    if phat:
        Yw = Y_tfm / (jnp.abs(Y_tfm) + 1e-6)
    else:
        Yw = Y_tfm
    # [T, ..., F, M] x [Theta, F, M] -> [T, ..., Theta, F]
    acc = jnp.einsum("afm,...fm->...af", jnp.conj(grid).astype(Y_tfm.dtype), Yw, precision="highest")
    return jnp.sum(jnp.abs(acc), axis=-1)


def srp_process(
    x: jnp.ndarray, geometry: ArrayGeometry, cfg: SrpConfig = SrpConfig(),
    phat: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Offline SRP-PHAT of a time batch.

    x: [..., M, S].  Returns (angle_spectrum [..., T, Theta], p [..., T, F])
    with the same MCRA track the reference also reports (srp.py:37-41).
    The angle spectrum is one XLA einsum that materialises the [T, ..,
    Theta, F] steered field in device memory."""
    X = analysis(x, cfg.stft)  # [..., M, T, F]
    Y = jnp.moveaxis(jnp.moveaxis(X, -3, -1), -3, 0)  # [T, ..., F, M]
    grid = srp_steering_grid(cfg, geometry)
    spec = jnp.moveaxis(srp_angle_spectrum(Y, jnp.asarray(grid), phat=phat), 0, -2)
    power = jnp.abs(Y[..., 0]) ** 2  # [T, ..., F]
    _, p = mcra_run(cfg.mcra, power)
    return spec, jnp.moveaxis(p, 0, -2)
