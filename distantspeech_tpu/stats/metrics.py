"""Beamformer quality metrics: array gain, WNG, DI, beampattern.

Fully-broadcast replacements for the reference's azimuth x bin loops
(beamformer.compute_array_gain beamformer.py:435-461, compute_wng_di
:463-501, compute_beampattern :503-534).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from distantspeech_tpu.array.geometry import ArrayGeometry
from distantspeech_tpu.array.steering import steering_vector
from distantspeech_tpu.array.coherence import diffuse_coherence


def array_gain(weights, steer, Rvv, return_db: bool = False):
    """G = |w^H a|^2 / |w^H Rvv w| per bin.

    weights, steer: [..., F, C]; Rvv: [..., F, C, C] -> [..., F].
    """
    num = jnp.einsum("...i,...i->...", jnp.conj(weights), steer, precision="highest")
    den = jnp.einsum("...i,...ij,...j->...", jnp.conj(weights), Rvv, weights, precision="highest")
    G = jnp.abs(num) ** 2 / jnp.abs(den)
    if return_db:
        G = 10.0 * jnp.log10(G + 1e-6)
    return G


def wng_di(geometry: ArrayGeometry, weights, look_angle_deg, n_fft: int, return_db: bool = True):
    """White-noise gain and directivity index of ``weights`` toward a look angle.

    weights: [F, C] -> (wng [F], di [F]).
    """
    angle_rad = np.asarray(look_angle_deg, dtype=np.float64) / 180.0 * np.pi
    steer = jnp.asarray(steering_vector(geometry, angle_rad, n_fft))
    fvv = jnp.asarray(diffuse_coherence(geometry, n_fft))
    di = array_gain(weights, steer, fvv.astype(weights.dtype))
    eye = jnp.broadcast_to(jnp.eye(geometry.n_mics, dtype=weights.dtype), fvv.shape)
    wng = array_gain(weights, steer, eye)
    if return_db:
        wng = 10.0 * jnp.log10(wng + 1e-6)
        di = 10.0 * jnp.log10(di + 1e-6)
    return wng, di


def beampattern(geometry: ArrayGeometry, weights, n_fft: int, n_azimuths: int = 360):
    """|w^H a(az)| over a full azimuth sweep, in dB.

    weights: [F, C] -> [n_azimuths, F].  One einsum over all (az, bin) pairs
    instead of the reference's 360 x F scalar loop (beamformer.py:525-533).
    """
    az = np.arange(n_azimuths) * (360.0 / n_azimuths) / 180.0 * np.pi
    angles = np.stack([az, np.zeros_like(az)], axis=-1)
    a = jnp.asarray(steering_vector(geometry, angles, n_fft))  # [A, F, C]
    resp = jnp.abs(jnp.einsum("fc,afc->af", jnp.conj(weights), a.astype(weights.dtype), precision="highest"))
    return 20.0 * jnp.log10(resp + 1e-12)
