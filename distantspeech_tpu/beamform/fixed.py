"""Fixed beamformers: delay-and-sum and superdirective.

Oracle: FixedBeamformer (/root/reference/DistantSpeech/beamformer/fixedbeamformer.py:96-207)
— weights designed once on the host (NumPy; a 129 x M x M inverse is not
accelerator work, and host design keeps complex128 precision), application is
one jitted einsum over the whole batched spectrogram instead of the
reference's per-frame loop (fixedbeamformer.py:198-201).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from distantspeech_tpu.array.coherence import diffuse_coherence
from distantspeech_tpu.array.geometry import ArrayGeometry
from distantspeech_tpu.array.steering import steering_vector
from distantspeech_tpu.transform import StftConfig, analysis, synthesis


@dataclasses.dataclass(frozen=True)
class FixedBeamformerConfig:
    stft: StftConfig = StftConfig(256, 128)
    weight_type: str = "SD"  # 'DS' | 'SD'
    diag_value: float = 1e-3


def fixed_beamformer_weights(
    geometry: ArrayGeometry,
    look_angle_deg,
    cfg: FixedBeamformerConfig = FixedBeamformerConfig(),
) -> np.ndarray:
    """Design DS or superdirective weights on the host.

    DS: w = a / M (fixedbeamformer.py:136-137).
    SD: MVDR against the diffuse-field coherence with diagonal loading
    (fixedbeamformer.py:139-143).

    Returns [half_bin, M] complex128.
    """
    angle_rad = np.asarray(look_angle_deg, dtype=np.float64) / 180.0 * np.pi
    a0 = steering_vector(geometry, angle_rad, cfg.stft.n_fft)  # [F, M]
    if cfg.weight_type == "DS":
        return a0 / geometry.n_mics
    if cfg.weight_type == "SD":
        fvv = diffuse_coherence(geometry, cfg.stft.n_fft)
        fvv_inv = np.linalg.inv(fvv + cfg.diag_value * np.eye(geometry.n_mics))
        num = np.einsum("fij,fj->fi", fvv_inv, a0)
        den = np.einsum("fi,fi->f", a0.conj(), num)
        return num / den[:, None]
    raise ValueError(f"unknown weight_type {cfg.weight_type}")


def apply_weights(W: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
    """Y[..., t, f] = sum_c conj(W[f, c]) X[..., c, t, f] — the whole
    spectrogram at once (reference process_freframe einsum,
    fixedbeamformer.py:163, hoisted out of the frame loop)."""
    return jnp.einsum("fc,...ctf->...tf", jnp.conj(W), X, precision="highest")


def fixed_process(x: jnp.ndarray, W: jnp.ndarray, stft_cfg: StftConfig) -> jnp.ndarray:
    """Offline fixed beamforming of a time-domain batch.

    x: [..., C, S]  (channels-last-but-one, samples last)
    W: [F, C] complex weights
    Returns [..., S] enhanced signal (same streaming latency semantics as the
    reference: fresh-stream zero carries).
    """
    X = analysis(x, stft_cfg)  # [..., C, T, F]
    Y = apply_weights(W.astype(X.dtype), X)  # [..., T, F]
    return synthesis(Y, stft_cfg)
