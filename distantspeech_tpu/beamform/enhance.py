"""Flagship enhancement pipeline: adaptive MVDR + OM-LSA postfilter.

The benchmark configuration of this framework (BASELINE.json: "8-mic
MVDR+postfilter"): the reference's MCRA-gated adaptive MVDR beamformer
(adaptivebeamformer.py:44-128) followed by a single-channel OM-LSA
spectral gain on the beamformer output, built from the same primitives the
reference composes elsewhere (decision-directed prior SNR and
``G = G_H1^p * Gmin^(1-p)`` per McSppBase.compute_omlsa_weight,
mcspp_base.py:140-156, driven by the MVDR's own MCRA track).

One frame = one fused step over all bins; the whole utterance is a single
``lax.scan``; batches over any leading axes; bins shard over the ``fb`` mesh
axis (see ``distantspeech_tpu.parallel``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from distantspeech_tpu.array.geometry import ArrayGeometry
from distantspeech_tpu.array.steering import steering_vector
from distantspeech_tpu.beamform.mvdr import MvdrConfig, MvdrState, mvdr_init, mvdr_step
from distantspeech_tpu.transform import StftConfig, analysis, synthesis


@dataclasses.dataclass(frozen=True)
class EnhanceConfig:
    # speech-scale minima window (L=65) + the raw-indicator covariance
    # guard: MCRA forces p = 0 for the first 2L frames (mcra.py:68-69), and
    # without the guard that one second of open VAD gate absorbs real
    # speech into Rvv (alpha_v 0.9998 ~ 5000-frame memory), self-cancelling
    # the target for the rest of the utterance — measured -18 dB SI-SDR on
    # the real-speech mix vs +5.1 dB with the guard on a led-in capture
    # (round-4 real-speech evaluation).  rel_diag is the f32 conditioning guard
    # (see MvdrConfig).
    mvdr: MvdrConfig = MvdrConfig(mcra_L=65, vad_guard=True, rel_diag=1e-5)
    alpha_xi: float = 0.92  # decision-directed pole
    gmin: float = 0.0631  # -24 dB gain floor (mcspp_base.py:140)

    @property
    def stft(self) -> StftConfig:
        return self.mvdr.stft


class EnhanceState(NamedTuple):
    mvdr: MvdrState
    G_H1: jnp.ndarray  # [..., F]
    gamma: jnp.ndarray  # [..., F]


def enhance_init(cfg: EnhanceConfig, n_mics: int, batch_shape=(), cdtype=jnp.complex64) -> EnhanceState:
    rdtype = jnp.zeros(0, dtype=cdtype).real.dtype
    F = cfg.stft.half_bin
    return EnhanceState(
        mvdr=mvdr_init(cfg.mvdr, n_mics, batch_shape, cdtype=cdtype),
        G_H1=jnp.ones((*batch_shape, F), dtype=rdtype),
        gamma=jnp.ones((*batch_shape, F), dtype=rdtype),
    )


def enhance_step(
    cfg: EnhanceConfig, steer: jnp.ndarray, state: EnhanceState, Z: jnp.ndarray
) -> Tuple[EnhanceState, jnp.ndarray]:
    """One frame: MVDR beamform + OM-LSA gain.  Z: [..., F, M] -> Y [..., F]."""
    mvdr_state, Yf = mvdr_step(cfg.mvdr, steer, state.mvdr, Z)

    lam = jnp.maximum(mvdr_state.mcra.lambda_d, 1e-10)
    p = mvdr_state.mcra.p
    gamma = jnp.abs(Yf) ** 2 / lam
    xi = cfg.alpha_xi * state.G_H1**2 * state.gamma + (1.0 - cfg.alpha_xi) * jnp.maximum(gamma - 1.0, 0.0)
    G_H1 = xi / (1.0 + xi)
    G = jnp.clip(G_H1**p * cfg.gmin ** (1.0 - p), cfg.gmin, 1.0)

    return EnhanceState(mvdr=mvdr_state, G_H1=G_H1, gamma=gamma), Yf * G


def enhance_scan(cfg: EnhanceConfig, steer: jnp.ndarray, state: EnhanceState, Zt: jnp.ndarray, unroll: int = 8):
    """Scan over the frame axis.  Zt: [T, ..., F, M].

    ``unroll`` amortises the per-step scan overhead — each XLA loop
    iteration runs several frames back to back (the recursion itself stays
    exact); 8 is a good default for the [B, F, M, M] working set."""
    return jax.lax.scan(lambda s, z: enhance_step(cfg, steer, s, z), state, Zt, unroll=unroll)


def enhance_scan_pallas(
    cfg: EnhanceConfig, steer: jnp.ndarray, Zt: jnp.ndarray, interpret: bool = False
) -> jnp.ndarray:
    """Fast path of ``enhance_scan``: the same math in two passes.

    1. MCRA over frames — a cheap elementwise XLA scan (its cross-bin
       smoothing halo stays out of the kernel);
    2. the covariance/solve frame loop AND the per-bin OM-LSA gain
       recursion — one Pallas kernel through Triton (``ops.pallas_mvdr``).

    Zt: [T, B, F, M] (exactly 4-D).  Returns Y [T, B, F].  Numerics match
    ``enhance_scan`` to float32 rounding (tests/test_pallas_mvdr.py).
    Needs a CUDA GPU unless ``interpret=True``.
    """
    from distantspeech_tpu.noise.mcra import mcra_run
    from distantspeech_tpu.ops.pallas_mvdr import pallas_mvdr_omlsa

    if Zt.ndim != 4:
        raise ValueError(
            f"enhance_scan_pallas needs Zt of shape [T, B, F, M] (4-D), got {Zt.shape}; "
            "add a size-1 batch axis for single utterances, or use backend='scan'"
        )
    mv = cfg.mvdr
    power = jnp.real(Zt[..., 0] * jnp.conj(Zt[..., 0]))  # [T, B, F]
    lam, p, sr = mcra_run(mv.mcra, power, return_sr=True)
    gate = p < mv.p_vad
    if mv.vad_guard:
        gate = gate & (sr <= mv.mcra.delta_s)

    return pallas_mvdr_omlsa(
        Zt, gate.astype(jnp.float32), steer, p, lam, alpha_v=mv.alpha_v, diag=mv.diag,
        rel_diag=mv.rel_diag, alpha_xi=cfg.alpha_xi, gmin=cfg.gmin, interpret=interpret,
    )


def enhance_process(
    x: jnp.ndarray,
    geometry: ArrayGeometry,
    look_angle_deg=(90.0, 0.0),
    cfg: EnhanceConfig = EnhanceConfig(),
    backend: str = "scan",
) -> jnp.ndarray:
    """Offline MVDR+OM-LSA of a time-domain batch.  x: [..., M, S] -> [..., S].

    backend: 'scan' (the plain ``lax.scan`` path: any batch shape, any
    device) or 'pallas' (the MVDR/OM-LSA frame loop as one Triton kernel;
    needs x of shape [B, M, S] and a CUDA GPU)."""
    if backend not in ("scan", "pallas"):
        raise ValueError(f"enhance_process: backend must be 'scan' or 'pallas', got {backend!r}")
    angle_rad = np.asarray(look_angle_deg, dtype=np.float64) / 180.0 * np.pi
    steer = jnp.asarray(steering_vector(geometry, angle_rad, cfg.stft.n_fft))

    X = analysis(x, cfg.stft)  # [..., M, T, F]
    Zt = jnp.moveaxis(jnp.moveaxis(X, -3, -1), -3, 0)  # [T, ..., F, M]
    if backend == "pallas":
        Y = enhance_scan_pallas(cfg, steer.astype(Zt.dtype), Zt)
    else:
        state = enhance_init(cfg, geometry.n_mics, batch_shape=Zt.shape[1:-2], cdtype=Zt.dtype)
        _, Y = enhance_scan(cfg, steer.astype(Zt.dtype), state, Zt)
    return synthesis(jnp.moveaxis(Y, 0, -2), cfg.stft)
