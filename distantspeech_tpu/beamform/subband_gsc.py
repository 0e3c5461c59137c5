"""Subband GSC: subband-LMS blocking matrix + multichannel subband-LMS AIC.

Oracle: SubbandGSC.process (/root/reference/DistantSpeech/beamformer/
SubbandGSC.py:170-263).  Per frameLen block: DC notch, fractional-delay
alignment, McSpp speech presence from the aligned spectra, a per-mic
subband NLMS blocking matrix estimating the FBF->mic transfer (p-gated), a
frameLen sample delay on the FBF path, and a [bin, tap, mic] subband NLMS
interference canceller gated by 1-p.  All subband filters run through the
same STFT round-trip the reference's SubbandAF time-domain dispatch uses
(Transform with n_fft = 2*frameLen, hop = frameLen — SubbandAF.py:37-39).

The M per-mic BM filters and their transforms batch over a leading mic axis.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from distantspeech_tpu.adaptive.feature import dc_notch, dc_notch_init
from distantspeech_tpu.adaptive.subband import (
    SubbandAfConfig,
    SubbandLmsState,
    subband_lms_init,
    subband_lms_mc_step,
    subband_lms_step,
)
from distantspeech_tpu.array.alignment import time_alignment_filters
from distantspeech_tpu.array.geometry import ArrayGeometry
from distantspeech_tpu.noise.mcspp import McSppConfig, McSppState, mcspp_init, mcspp_step
from distantspeech_tpu.ops.delay import delay_samples
from distantspeech_tpu.ops.fir import fir_filter_offline
from distantspeech_tpu.transform import StftConfig
from distantspeech_tpu.transform.stft import istft_stream, stft_frames, stft_stream


@dataclasses.dataclass(frozen=True)
class SubbandGscConfig:
    n_mics: int = 4
    frame_len: int = 256
    aic_freeze_thresh: float = 0.0  # > 0: HARD-freeze the AIC where the
    # McSpp speech presence exceeds this threshold, instead of merely
    # down-weighting by (1-p) — the reference's soft gate keeps the
    # canceller adapting at ~half rate during speech whenever p is mushy
    # (measured 0.3-0.6 on the real-speech mix).  0 matches the reference
    # bit-exactly.
    aic_warmup_frames: int = 0  # > 0: freeze the AIC for the first N
    # frames while McSpp's noise tracks initialise (its p sits near 0 for
    # ~2 s on captures that start mid-speech, so the canceller adapts on
    # target-present frames; N = 130 measured +0.6 dB SI-SDR over the
    # reference behaviour on the real-speech mixes).
    # 0 matches the reference bit-exactly.

    @property
    def stft(self) -> StftConfig:
        return StftConfig(self.frame_len * 2, self.frame_len)

    @property
    def half_bin(self) -> int:
        return self.frame_len + 1

    @property
    def spp(self) -> McSppConfig:
        return McSppConfig(nfft=self.frame_len * 2, n_channels=self.n_mics)

    @property
    def bm(self) -> SubbandAfConfig:
        # SubbandLMS(filter_len=2, num_bands=2L, mu=0.1) (SubbandGSC.py:97-99)
        return SubbandAfConfig(num_bands=self.frame_len * 2, filter_len=2, mu=0.1)

    @property
    def aic(self) -> SubbandAfConfig:
        # SubbandLmsMc(filter_len=2, num_bands=2L, mu=0.01, alpha=0.8) (:101-107)
        return SubbandAfConfig(
            num_bands=self.frame_len * 2, filter_len=2, n_channels=self.n_mics, mu=0.01, alpha=0.8
        )


class SubbandGscCoreState(NamedTuple):
    """The genuinely recursive part: McSpp + the two subband AFs and their
    output-side transform carries (everything the input spectra can't
    precompute)."""

    spp: McSppState
    bm: SubbandLmsState  # leading mic axis
    istft_bm: jnp.ndarray  # BM error synthesis carries [..., M, L]
    aic: SubbandLmsState
    stft_aic_x: jnp.ndarray  # AIC input (bm out) carry [..., M, L]
    istft_aic: jnp.ndarray  # AIC error synthesis carry [..., L]


class SubbandGscState(NamedTuple):
    """Streaming state: the input-side transform carries + the core.

    (The round-5 restructure hoisted the input-only transforms — aligned
    spectra, FBF spectra, delayed-FBF spectra — out of the offline scan
    into bulk matmuls; streaming keeps them as carries and feeds the same
    ``subband_gsc_core_step``.  The former duplicate ``stft_bm_d`` carry is
    gone: it transformed the same ``aligned`` block as ``stft_al``.)"""

    stft_al: jnp.ndarray  # aligned-spectra carry [..., M, L]
    stft_fbf: jnp.ndarray  # FBF analysis carry [..., L]
    delay_fbf: jnp.ndarray  # [..., L]
    stft_fbf_d: jnp.ndarray  # delayed-FBF analysis carry [..., L]
    core: SubbandGscCoreState


def subband_gsc_core_init(
    cfg: SubbandGscConfig, batch_shape=(), dtype=jnp.float32
) -> SubbandGscCoreState:
    L, M = cfg.frame_len, cfg.n_mics
    cdtype = jnp.result_type(dtype, jnp.complex64)
    z = lambda *s: jnp.zeros((*batch_shape, *s), dtype=dtype)
    return SubbandGscCoreState(
        spp=mcspp_init(cfg.spp, batch_shape, cdtype=cdtype),
        bm=subband_lms_init(cfg.bm, (*batch_shape, M), cdtype=cdtype),
        istft_bm=z(M, L),
        aic=subband_lms_init(cfg.aic, batch_shape, cdtype=cdtype),
        stft_aic_x=z(M, L),
        istft_aic=z(L),
    )


def subband_gsc_init(cfg: SubbandGscConfig, batch_shape=(), dtype=jnp.float32) -> SubbandGscState:
    L, M = cfg.frame_len, cfg.n_mics
    z = lambda *s: jnp.zeros((*batch_shape, *s), dtype=dtype)
    return SubbandGscState(
        stft_al=z(M, L),
        stft_fbf=z(L),
        delay_fbf=z(L),
        stft_fbf_d=z(L),
        core=subband_gsc_core_init(cfg, batch_shape, dtype=dtype),
    )


def subband_gsc_core_step(
    cfg: SubbandGscConfig, Fn: jnp.ndarray, state: SubbandGscCoreState,
    D: jnp.ndarray, Xf: jnp.ndarray, Yf: jnp.ndarray,
) -> Tuple[SubbandGscCoreState, Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]]:
    """One frameLen block on precomputed input spectra.

    D: [..., M, F] aligned-mic spectra; Xf: [..., F] FBF spectrum;
    Yf: [..., F] frameLen-delayed FBF spectrum.  Fn: diffuse pair coherence
    for the McSpp CDR (cfg.spp.mccdr.fn_pair()).
    Returns (state, (output [..., L], p [..., F], bm_out [..., M, L]))."""
    scfg = cfg.stft
    spp_state, spp_out = mcspp_step(cfg.spp, Fn, state.spp, jnp.moveaxis(D, -2, -1))
    p = spp_out.p

    # --- blocking matrix: per-mic SubbandLMS(fbf -> mic), p-gated ----------
    x_spec = jnp.broadcast_to(Xf[..., None, :], D.shape)  # [..., M, F]
    bm_state, e_bm = subband_lms_step(cfg.bm, state.bm, x_spec, D, p=p[..., None, :])
    istft_bm, bm_out = istft_stream(state.istft_bm, e_bm[..., None, :], scfg)  # [..., M, L]

    # --- AIC: multichannel SubbandLmsMc(bm_out -> delayed fbf), (1-p)-gated
    stft_aic_x, Uf = stft_stream(state.stft_aic_x, bm_out, scfg)  # [..., M, 1, F]
    gate = 1.0 - p
    if cfg.aic_freeze_thresh > 0.0:
        gate = gate * (p <= cfg.aic_freeze_thresh)
    if cfg.aic_warmup_frames > 0:
        gate = gate * (state.spp.frm_cnt >= cfg.aic_warmup_frames)
    aic_state, e_aic = subband_lms_mc_step(
        cfg.aic, state.aic, jnp.moveaxis(Uf[..., 0, :], -2, -1), Yf, p=gate
    )
    istft_aic, out = istft_stream(state.istft_aic, e_aic[..., None, :], scfg)

    new_state = SubbandGscCoreState(
        spp=spp_state, bm=bm_state, istft_bm=istft_bm,
        aic=aic_state, stft_aic_x=stft_aic_x, istft_aic=istft_aic,
    )
    return new_state, (out, p, bm_out)


def subband_gsc_step(
    cfg: SubbandGscConfig, Fn: jnp.ndarray, state: SubbandGscState, aligned: jnp.ndarray
) -> Tuple[SubbandGscState, Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]]:
    """One frameLen block from time-domain input (the streaming entry).

    aligned: [..., M, L] time-aligned mics.
    Returns (state, (output [..., L], p [..., F], bm_out [..., M, L]))."""
    scfg = cfg.stft
    fbf = jnp.mean(aligned, axis=-2)
    stft_al, D = stft_stream(state.stft_al, aligned, scfg)  # [..., M, 1, F]
    stft_fbf, Xf = stft_stream(state.stft_fbf, fbf, scfg)  # [..., 1, F]
    delay_fbf, fbf_d = delay_samples(state.delay_fbf, fbf)
    stft_fbf_d, Yf = stft_stream(state.stft_fbf_d, fbf_d, scfg)  # [..., 1, F]
    core, out = subband_gsc_core_step(
        cfg, Fn, state.core, D[..., 0, :], Xf[..., 0, :], Yf[..., 0, :]
    )
    return SubbandGscState(
        stft_al=stft_al, stft_fbf=stft_fbf, delay_fbf=delay_fbf,
        stft_fbf_d=stft_fbf_d, core=core,
    ), out


def subband_gsc_process(
    x: jnp.ndarray, geometry: ArrayGeometry, angle_rad=(197.0 / 180.0 * np.pi, 0.0),
    cfg: SubbandGscConfig = SubbandGscConfig(), unroll: int = 1,
):
    """Offline SubbandGSC.  x: [..., M, S].

    Returns (output [..., S], p [..., T, F], bm_output [..., M, S']).

    Everything input-only — DC notch, alignment, and ALL input-side
    analysis transforms (aligned spectra, FBF, delayed FBF) — is computed
    over the whole utterance in bulk matmuls; only the genuinely recursive
    core (McSpp + the two subband AFs + output-side transforms) rides the
    ``lax.scan``.  Bit-identical to scanning ``subband_gsc_step``
    (stft_stream == stft_frames of the zero-padded signal).

    ``unroll``: frame-scan lowering hint, numerically inert (see gsc.py)."""
    L = cfg.frame_len
    scfg = cfg.stft
    _, xn = dc_notch(dc_notch_init(x.shape[:-1], dtype=x.dtype), x, radius=0.98)
    coeffs = jnp.asarray(time_alignment_filters(geometry, angle_rad), dtype=x.dtype)
    aligned = fir_filter_offline(xn, coeffs)

    T = x.shape[-1] // L
    aligned = aligned[..., : T * L]
    fbf = jnp.mean(aligned, axis=-2)
    fbf_d = jnp.pad(fbf, [(0, 0)] * (fbf.ndim - 1) + [(L, 0)])[..., : T * L]
    ov = [(0, 0)] * (x.ndim - 1) + [(scfg.overlap, 0)]
    D_all = stft_frames(jnp.pad(aligned, ov), scfg)  # [..., M, T, F]
    Xf_all = stft_frames(jnp.pad(fbf, ov[1:]), scfg)  # [..., T, F]
    Yf_all = stft_frames(jnp.pad(fbf_d, ov[1:]), scfg)  # [..., T, F]
    Fn = jnp.asarray(cfg.spp.mccdr.fn_pair(), dtype=x.dtype)

    Dt = jnp.moveaxis(D_all, -2, 0)  # [T, ..., M, F]
    Xt = jnp.moveaxis(Xf_all, -2, 0)  # [T, ..., F]
    Yt = jnp.moveaxis(Yf_all, -2, 0)

    state = subband_gsc_core_init(cfg, batch_shape=x.shape[:-2], dtype=x.dtype)
    _, (out, p, bm_out) = jax.lax.scan(
        lambda s, inp: subband_gsc_core_step(cfg, Fn, s, *inp), state, (Dt, Xt, Yt),
        unroll=unroll,
    )
    out = jnp.moveaxis(out, 0, -2).reshape(*x.shape[:-2], T * L)
    bm_full = jnp.moveaxis(bm_out, 0, -2).reshape(*x.shape[:-2], cfg.n_mics, T * L)
    return out, jnp.moveaxis(p, 0, -2), bm_full
