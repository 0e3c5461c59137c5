"""Robust overlap-save frequency GSC (Herbordt/Kellermann style).

Oracle: FDGSC.process (/root/reference/DistantSpeech/beamformer/FDGSC.py:201-317):
per frameLen block — DC notch, fractional-delay alignment, mean FBF,
**adaptive** blocking matrix (one CCAF-clamped FLMS per mic estimating the
FBF->mic transfer, mode 3, FDGSC.py:141-152, :255-262), causality delays
(aligned by L/2, FBF by L), norm-constrained multichannel AIC stepped by the
scalar ``1 - mean(p)`` of an MCRA(L=60) track on the raw reference channel.

Reference quirks reproduced:
- the p post-processing that pins the low 32 bins to >= 0.8 when the
  mid-band mean exceeds 0.8 mutates the *returned* p array, and the AIC
  stepsize is the mean of that mutated column (FDGSC.py:241-253, :275-281);
- the BM filters update with p = 1 (the gating arg is commented out in the
  reference call);
- ``spp_fbf`` is advanced but its output is never consumed (FDGSC.py:270-272)
  — omitted here;
- the reference's ``postfilter=True`` branch re-runs a streaming STFT over
  the whole accumulated bm_output buffer each frame and reads frame 0 — a
  bug we do not reproduce; this implementation's postfilter applies
  OMLSA-multi on the current frame (documented deviation), default off.

The M per-mic BM filters run as ONE batched FLMS with a leading mic axis.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from distantspeech_tpu.adaptive.feature import dc_notch, dc_notch_init
from distantspeech_tpu.adaptive.flms import FlmsConfig, FlmsState, flms_init
from distantspeech_tpu.array.alignment import time_alignment_filters
from distantspeech_tpu.array.geometry import ArrayGeometry
from distantspeech_tpu.beamform.gsc_filters import aic_step, bm_step
from distantspeech_tpu.noise.mcra import McraConfig, McraState, mcra_init, mcra_step
from distantspeech_tpu.noise.omlsa import OmlsaConfig, OmlsaState, omlsa_init, omlsa_step
from distantspeech_tpu.ops.delay import delay_samples
from distantspeech_tpu.ops.fir import fir_filter_offline
from distantspeech_tpu.transform import StftConfig
from distantspeech_tpu.transform.stft import istft_stream, stft_stream


@dataclasses.dataclass(frozen=True)
class FdGscConfig:
    n_mics: int = 4
    frame_len: int = 256
    postfilter: bool = False

    @property
    def stft(self) -> StftConfig:
        return StftConfig(self.frame_len * 2, self.frame_len)

    @property
    def half_bin(self) -> int:
        return self.frame_len + 1

    @property
    def mcra(self) -> McraConfig:
        return McraConfig(nfft=self.frame_len * 2, L=60)  # FDGSC.py:97-102

    @property
    def bm(self) -> FlmsConfig:
        return FlmsConfig(filter_len=self.frame_len, mu=0.1, alpha=0.9)  # FDGSC.py:71-80

    @property
    def aic(self) -> FlmsConfig:
        return FlmsConfig(filter_len=self.frame_len, n_channels=self.n_mics, mu=0.1, alpha=0.9)

    @property
    def omlsa(self) -> OmlsaConfig:
        return OmlsaConfig(nfft=self.frame_len * 2, n_channels=self.n_mics)


class FdGscState(NamedTuple):
    stft_x: jnp.ndarray  # raw-input spp transform carry [..., M, L]
    mcra: McraState
    bm: FlmsState  # batched over a leading mic axis: [..., M, 1, *]
    aic: FlmsState
    delay_aligned: jnp.ndarray  # [..., M, L/2]
    delay_fbf: jnp.ndarray  # [..., L]
    omlsa: OmlsaState
    stft_y: jnp.ndarray
    istft_y: jnp.ndarray


def fdgsc_init(cfg: FdGscConfig, batch_shape=(), dtype=jnp.float32) -> FdGscState:
    L, M = cfg.frame_len, cfg.n_mics
    return FdGscState(
        stft_x=jnp.zeros((*batch_shape, M, L), dtype=dtype),
        mcra=mcra_init(cfg.mcra, batch_shape, dtype=dtype),
        bm=flms_init(cfg.bm, (*batch_shape, M), dtype=dtype),
        aic=flms_init(cfg.aic, batch_shape, dtype=dtype),
        delay_aligned=jnp.zeros((*batch_shape, M, L // 2), dtype=dtype),
        delay_fbf=jnp.zeros((*batch_shape, L), dtype=dtype),
        omlsa=omlsa_init(cfg.omlsa, batch_shape, dtype=dtype),
        stft_y=jnp.zeros((*batch_shape, L), dtype=dtype),
        istft_y=jnp.zeros((*batch_shape, L), dtype=dtype),
    )


def fdgsc_step(
    cfg: FdGscConfig, state: FdGscState, x: jnp.ndarray, aligned: jnp.ndarray
) -> Tuple[FdGscState, Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]]:
    """One frameLen block.

    x: [..., M, L] raw mics; aligned: [..., M, L] time-aligned mics.
    Returns (state, (output [..., L], p [..., F], bm_out [..., M, L]))."""
    scfg = cfg.stft
    fbf = jnp.mean(aligned, axis=-2)  # [..., L]

    stft_x, D = stft_stream(state.stft_x, x, scfg)  # [..., M, 1, F]
    power = jnp.abs(D[..., 0, 0, :]) ** 2  # reference channel, single frame
    mcra_state, (_, p) = mcra_step(cfg.mcra, state.mcra, power)

    # returned-p mutation quirk (FDGSC.py:249-253)
    mid_mean = jnp.mean(p[..., 32:128], axis=-1, keepdims=True)
    low = p[..., :32]
    low_pinned = jnp.where(mid_mean > 0.8, jnp.maximum(low, 0.8), low)
    p_ret = jnp.concatenate([low_pinned, p[..., 32:]], axis=-1)

    # causality delays (FDGSC.py:92-95, :264-270)
    delay_aligned, aligned_d = delay_samples(state.delay_aligned, aligned)
    delay_fbf, fbf_d = delay_samples(state.delay_fbf, fbf)

    # adaptive BM, mode 3: per mic, input = fbf, desired = delayed aligned mic
    bm_in = jnp.broadcast_to(fbf[..., None, None, :], (*aligned.shape[:-1], 1, fbf.shape[-1]))
    bm_state, (bm_out, _) = bm_step(cfg.bm, state.bm, bm_in, aligned_d)  # e: [..., M, L]

    # AIC with scalar stepsize gate 1 - mean(p_ret) (FDGSC.py:275-281)
    gate = 1.0 - jnp.mean(p_ret, axis=-1)
    aic_state, (out, _) = aic_step(
        cfg.aic, state.aic, bm_out, fbf_d, p=gate[..., None, None], weight_norm=True
    )

    omlsa_state, stft_y, istft_y = state.omlsa, state.stft_y, state.istft_y
    if cfg.postfilter:
        stft_y, Y = stft_stream(state.stft_y, out, scfg)
        omlsa_state, (_, _, G) = omlsa_step(
            cfg.omlsa, state.omlsa,
            jnp.abs(Y[..., 0, :]) ** 2,
            jnp.abs(D[..., :-1, 0, :]) ** 2,
        )
        Yg = Y[..., 0, :] * jnp.sqrt(G).astype(Y.dtype)
        istft_y, out = istft_stream(state.istft_y, Yg[..., None, :], scfg)

    new_state = FdGscState(
        stft_x=stft_x, mcra=mcra_state, bm=bm_state, aic=aic_state,
        delay_aligned=delay_aligned, delay_fbf=delay_fbf,
        omlsa=omlsa_state, stft_y=stft_y, istft_y=istft_y,
    )
    return new_state, (out, p_ret, bm_out)


def fdgsc_process(
    x: jnp.ndarray, geometry: ArrayGeometry, angle_rad=(197.0 / 180.0 * np.pi, 0.0),
    cfg: FdGscConfig = FdGscConfig(), dc_notch_input: bool = True, unroll: int = 1,
):
    """Offline FDGSC.  x: [..., M, S].

    Returns (output [..., S], p [..., T, F], bm_output [..., M, S']).

    ``unroll``: frame-scan lowering hint, numerically inert (see gsc.py)."""
    L = cfg.frame_len
    if dc_notch_input:
        _, x = dc_notch(dc_notch_init(x.shape[:-1], dtype=x.dtype), x, radius=0.98)
    coeffs = jnp.asarray(time_alignment_filters(geometry, angle_rad), dtype=x.dtype)
    aligned = fir_filter_offline(x, coeffs)

    T = x.shape[-1] // L
    xb = jnp.moveaxis(x[..., : T * L].reshape(*x.shape[:-1], T, L), -2, 0)
    ab = jnp.moveaxis(aligned[..., : T * L].reshape(*x.shape[:-1], T, L), -2, 0)

    state = fdgsc_init(cfg, batch_shape=x.shape[:-2], dtype=x.dtype)
    _, (out, p, bm_out) = jax.lax.scan(
        lambda s, blocks: fdgsc_step(cfg, s, blocks[0], blocks[1]), state, (xb, ab),
        unroll=unroll,
    )
    out = jnp.moveaxis(out, 0, -2).reshape(*x.shape[:-2], T * L)
    bm_full = jnp.moveaxis(bm_out, 0, -2)  # [..., M, T, L]
    bm_full = bm_full.reshape(*bm_full.shape[:-2], T * L)
    return out, jnp.moveaxis(p, 0, -2), bm_full
