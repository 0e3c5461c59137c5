"""Frequency-domain recursive GSC with MC-MCRA-gated NLMS canceller.

Oracle: GSC.process with method=2
(/root/reference/DistantSpeech/beamformer/GSC.py:174-287): steering-based
fixed beamformer W = a/(a^H a), pairwise steering blocking matrix
U_i = a_0* Z_0 - a_{i+1}* Z_{i+1}, per-bin NLMS interference canceller G
gated by (1 - p_spp), multiplicative MC-MCRA OM-LSA postfilter gain.

The reference also advances an MCRA tracker and an OMLSA-multi estimator
whose outputs never reach the output path (GSC.py:242, :281-284) — they are
omitted here (zero output difference, less state).

The reference's per-(frame, bin) double loop (GSC.py:224-287) collapses to
one [F]-vectorised step scanned over frames.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from distantspeech_tpu.array.geometry import ArrayGeometry
from distantspeech_tpu.array.steering import omega_bins
from distantspeech_tpu.noise.mc_mcra import McMcraConfig, McMcraState, mc_mcra_init, mc_mcra_step
from distantspeech_tpu.transform import StftConfig, analysis, synthesis


@dataclasses.dataclass(frozen=True)
class GscConfig:
    n_mics: int = 4
    frame_len: int = 256
    mu: float = 0.01  # canceller stepsize (GSC.py:202)
    normalize_aic: bool = False  # power-normalise the canceller gradient.
    # The reference runs UNNORMALISED LMS (Pest[k] = 1, its normalisation is
    # commented out, GSC.py:270-274), which diverges on loud broadband input
    # — sooner in complex64.  True enables the reference's own commented-out
    # recursion Pest = rho*Pest + (1-rho)*sum|Z|^2; False matches it exactly.
    rho_pest: float = 0.9
    spp_rel_diag: float = 0.0  # relative diagonal loading for the MC-MCRA
    # Phi_vv inverse (see McMcraConfig.rel_diag) — needed for complex64
    # execution on near-coherent input; 0 matches the reference.

    @property
    def stft(self) -> StftConfig:
        return StftConfig(self.frame_len, self.frame_len // 2)

    @property
    def half_bin(self) -> int:
        return self.frame_len // 2 + 1

    @property
    def mc_mcra(self) -> McMcraConfig:
        return McMcraConfig(nfft=self.frame_len, n_channels=self.n_mics, rel_diag=self.spp_rel_diag)


def gsc_steering(cfg: GscConfig, geometry: ArrayGeometry, angle_rad) -> np.ndarray:
    """Propagation vector a [F, M] from the circular-array delay model
    ``tao = -r cos(el) cos(az - gamma_m) / c`` (GSC.py:194, :221)."""
    angle = np.asarray(angle_rad, dtype=np.float64)
    gamma = (np.arange(0, 360, int(360 / cfg.n_mics)) * np.pi / 180.0)[: cfg.n_mics]
    # the reference reads r as the scalar radius of the (circular) array
    r = float(np.max(np.linalg.norm(geometry.mic_loc[:, :2], axis=-1)))
    tao = -1.0 * r * np.cos(angle[1]) * np.cos(angle[0] - gamma) / geometry.c  # [M]
    omega = omega_bins(cfg.frame_len, geometry.fs)  # [F]
    return np.exp(-1j * omega[:, None] * tao[None, :])  # [F, M]


class GscState(NamedTuple):
    G: jnp.ndarray  # canceller weights [..., F, M-1]
    Pest: jnp.ndarray  # gradient-normalisation power [..., F] (ones when off)
    spp: McMcraState


def gsc_init(cfg: GscConfig, batch_shape=(), cdtype=jnp.complex64) -> GscState:
    rdtype = jnp.zeros(0, dtype=cdtype).real.dtype
    return GscState(
        G=jnp.zeros((*batch_shape, cfg.half_bin, cfg.n_mics - 1), dtype=cdtype),
        Pest=jnp.ones((*batch_shape, cfg.half_bin), dtype=rdtype),
        spp=mc_mcra_init(cfg.mc_mcra, batch_shape, dtype=rdtype),
    )


def gsc_step(
    cfg: GscConfig, a: jnp.ndarray, state: GscState, Z: jnp.ndarray
) -> Tuple[GscState, jnp.ndarray]:
    """One frame.  a: [F, M] propagation vector; Z: [..., F, M] spectra.
    Returns (state, Y [..., F] postfiltered output)."""
    spp_state, spp_out = mc_mcra_step(cfg.mc_mcra, state.spp, Z)

    W = a / jnp.sum(jnp.abs(a) ** 2, axis=-1, keepdims=True)  # a/(a^H a)
    # multiply-reduce instead of einsum: keeps the tiny-M contraction
    # elementwise (see the mc_mcra_step note on batched small dot_generals)
    Yfbf = jnp.sum(jnp.conj(W) * Z, axis=-1)
    # blocking matrix: U_i = a_0* Z_0 - a_{i+1}* Z_{i+1} (GSC.py:217-222, :262)
    U = jnp.conj(a[:, :1]) * Z[..., :1] - jnp.conj(a[:, 1:]) * Z[..., 1:]  # [..., F, M-1]

    Y = Yfbf - jnp.sum(jnp.conj(state.G) * U, axis=-1)
    if cfg.normalize_aic:
        power = jnp.sum(jnp.real(Z * jnp.conj(Z)), axis=-1)
        Pest = cfg.rho_pest * state.Pest + (1.0 - cfg.rho_pest) * power
        Pest = jnp.maximum(Pest, 1e-10)
    else:
        Pest = state.Pest  # stays 1 (GSC.py:270)
    G = state.G + (cfg.mu * (1.0 - spp_out.p) / Pest)[..., None] * U * jnp.conj(Y)[..., None]

    Y_out = Y * spp_out.G  # OM-LSA postfilter gain (GSC.py:286)
    return GscState(G=G, Pest=Pest, spp=spp_state), Y_out


def gsc_process(
    x: jnp.ndarray, geometry: ArrayGeometry, angle_rad=(197.0 / 180.0 * np.pi, 0.0),
    cfg: GscConfig = GscConfig(), unroll: int = 1,
) -> jnp.ndarray:
    """Offline GSC of a time-domain batch.  x: [..., M, S] -> [..., S].

    ``unroll`` is a pure lowering hint on the frame scan (numerics
    identical): amortises per-step loop overhead like enhance_scan's
    unroll=8, at the cost of an 8x larger loop body to compile."""
    a = jnp.asarray(gsc_steering(cfg, geometry, angle_rad))
    X = analysis(x, cfg.stft)  # [..., M, T, F]
    Zt = jnp.moveaxis(jnp.moveaxis(X, -3, -1), -3, 0)  # [T, ..., F, M]
    state = gsc_init(cfg, batch_shape=Zt.shape[1:-2], cdtype=Zt.dtype)
    _, Y = jax.lax.scan(
        lambda s, z: gsc_step(cfg, a.astype(z.dtype), s, z), state, Zt, unroll=unroll
    )
    Y = jnp.moveaxis(Y, 0, -2)  # [..., T, F]
    return synthesis(Y, cfg.stft)


def gsc_process_time(
    x: jnp.ndarray,
    geometry: ArrayGeometry,
    angle_rad=(197.0 / 180.0 * np.pi, 0.0),
    frame_len: int = 256,
    fir_truncate: int = 30,
) -> jnp.ndarray:
    """Time-domain GSC path (``GSC.process1``, GSC.py:145-173): DC-notch
    each mic, fractional-delay time alignment, mean fixed beamformer,
    adjacent-difference blocking matrix, causal FLMS interference canceller
    at full adaptation rate (no SPP gating — the difference from TDGSC,
    whose canceller steps by 1-p and runs non-causal, TDGSC.py:37).

    x: [..., M, S] -> [..., S'] with S' = frame_len * (S // frame_len).
    """
    from distantspeech_tpu.adaptive.feature import dc_notch, dc_notch_init
    from distantspeech_tpu.adaptive.flms import FlmsConfig, flms_init, flms_step
    from distantspeech_tpu.array.alignment import time_alignment_filters
    from distantspeech_tpu.ops.fir import fir_filter_offline

    L = frame_len
    M = x.shape[-2]
    _, xn = dc_notch(dc_notch_init(x.shape[:-1], dtype=x.dtype), x, radius=0.98)
    coeffs = jnp.asarray(time_alignment_filters(geometry, angle_rad), dtype=x.dtype)
    aligned = fir_filter_offline(xn, coeffs)  # [..., M, S]
    fbf = jnp.mean(aligned, axis=-2)  # [..., S]
    bm = aligned[..., :-1, :] - aligned[..., 1:, :]  # [..., M-1, S]

    T = x.shape[-1] // L
    fbf_blocks = jnp.moveaxis(fbf[..., : T * L].reshape(*fbf.shape[:-1], T, L), -2, 0)
    bm_blocks = jnp.moveaxis(bm[..., : T * L].reshape(*bm.shape[:-1], T, L), -2, 0)

    aic = FlmsConfig(filter_len=L, n_channels=M - 1)  # causal, defaults (GSC.py:84)
    state = flms_init(aic, batch_shape=x.shape[:-2], dtype=x.dtype)
    _, (out, _) = jax.lax.scan(
        lambda s, fb: flms_step(aic, s, fb[1], fb[0], fir_truncate=fir_truncate),
        state,
        (fbf_blocks, bm_blocks),
    )
    return jnp.moveaxis(out, 0, -2).reshape(*x.shape[:-2], T * L)
