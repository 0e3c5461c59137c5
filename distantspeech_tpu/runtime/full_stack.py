"""Full streaming front-end stack: AEC -> GSC -> OMLSA postfilter (+ KWS tap).

BASELINE.json config 5: "full streaming stack: AEC (MDF) + GSC + MC-SPP
postfilter + dual-mic KWS frontend, batched utterances".  Composes the
framework's step functions into ONE carry pytree and one jittable block
step:

1. speex-style AEC cancels the far-end reference from every mic (the mono
   canceller batches over the mic axis);
2. the echo-free mics run through the time-domain GSC (alignment, blocking
   matrix, FLMS canceller, optional OMLSA postfilter);
3. a dual-mic KWS cleaner taps mics 0/1 of the AEC output as the
   hotword path.

Everything batches over leading axes and scans over blocks, so "batched
1024 utterances" is just a [1024, ...] leading dim.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from distantspeech_tpu.adaptive.aec import AecConfig, AecState, aec_init, aec_step
from distantspeech_tpu.adaptive.feature import DcNotchState, dc_notch, dc_notch_init
from distantspeech_tpu.array.alignment import time_alignment_filters
from distantspeech_tpu.array.geometry import ArrayGeometry
from distantspeech_tpu.beamform.tdgsc import TdGscConfig, TdGscState, tdgsc_init, tdgsc_step
from distantspeech_tpu.kws.dual_mic import DualMicKwsConfig, DualMicKwsState, kws_init, kws_step
from distantspeech_tpu.ops.fir import fir_filter_block


@dataclasses.dataclass(frozen=True)
class FullStackConfig:
    n_mics: int = 4
    frame_len: int = 256
    aec: AecConfig = AecConfig(filter_len=512, num_block=2)
    postfilter: bool = True

    @property
    def gsc(self) -> TdGscConfig:
        return TdGscConfig(n_mics=self.n_mics, frame_len=self.frame_len, postfilter=self.postfilter)

    @property
    def kws(self) -> DualMicKwsConfig:
        return DualMicKwsConfig(frame_len=self.frame_len)


class FullStackState(NamedTuple):
    aec: AecState  # batched over the mic axis
    notch: DcNotchState
    fir_cache: jnp.ndarray  # alignment FIR tail [..., M, K-1]
    gsc: TdGscState
    kws: DualMicKwsState


def full_stack_init(
    cfg: FullStackConfig, coeffs: np.ndarray, batch_shape=(), dtype=jnp.float32
) -> FullStackState:
    M = cfg.n_mics
    K = coeffs.shape[-1]
    return FullStackState(
        aec=aec_init(cfg.aec, (*batch_shape, M), dtype=dtype),
        notch=dc_notch_init((*batch_shape, M), dtype=dtype),
        fir_cache=jnp.zeros((*batch_shape, M, K - 1), dtype=dtype),
        gsc=tdgsc_init(cfg.gsc, batch_shape, dtype=dtype),
        kws=kws_init(cfg.kws, batch_shape, dtype=dtype),
    )


def full_stack_step(
    cfg: FullStackConfig, coeffs: jnp.ndarray, state: FullStackState,
    x: jnp.ndarray, far_end: jnp.ndarray,
) -> Tuple[FullStackState, Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]]:
    """One frame_len block through the whole stack.

    x: [..., M, L] mics; far_end: [..., L] playback reference.
    cfg.aec.block_len must equal cfg.frame_len.
    Returns (state, (enhanced [..., L], kws_clean [..., L], p [..., F])).
    """
    M, L = cfg.n_mics, cfg.frame_len

    # 1. echo cancellation on every mic (far-end broadcast across mics)
    far = jnp.broadcast_to(far_end[..., None, :], x.shape)
    aec_state, (echo_free, _) = aec_step(cfg.aec, state.aec, far, x)

    # 2. KWS tap on mics 0/1 of the echo-free signal
    kws_state, kws_clean = kws_step(cfg.kws, state.kws, echo_free[..., 0, :], echo_free[..., 1, :])

    # 3. DC notch + time alignment + fixed BF + blocking matrix + FLMS GSC
    notch_state, xn = dc_notch(state.notch, echo_free, radius=0.98)
    fir_cache, aligned = fir_filter_block(state.fir_cache, xn, coeffs)
    fbf = jnp.mean(aligned, axis=-2)
    bm = aligned[..., :-1, :] - aligned[..., 1:, :]
    gsc_state, (out, p) = tdgsc_step(cfg.gsc, state.gsc, fbf, bm)

    return (
        FullStackState(aec=aec_state, notch=notch_state, fir_cache=fir_cache, gsc=gsc_state, kws=kws_state),
        (out, kws_clean, p),
    )


def full_stack_process(
    x: jnp.ndarray, far_end: jnp.ndarray, geometry: ArrayGeometry,
    angle_rad=(197.0 / 180.0 * np.pi, 0.0), cfg: FullStackConfig = FullStackConfig(),
    unroll: int = 1,
):
    """Offline run of the full stack.

    x: [..., M, S]; far_end: [..., S].
    Returns (enhanced [..., S'], kws_clean [..., S'], p [..., T, F]).

    ``unroll``: frame-scan lowering hint, numerically inert (see gsc.py)."""
    if cfg.aec.block_len != cfg.frame_len:
        raise ValueError("aec.block_len must equal frame_len for the composed stack")
    L = cfg.frame_len
    T = x.shape[-1] // L
    # keep the host copy for init: converting via jnp under an outer jit
    # would make coeffs a tracer and break the static shape derivation
    coeffs_np = np.asarray(time_alignment_filters(geometry, angle_rad))
    from distantspeech_tpu.ops.fir import fir_block_taps

    # Toeplitz tap matrix built ONCE outside the scan (see fir_block_taps)
    coeffs = fir_block_taps(jnp.asarray(coeffs_np, dtype=x.dtype), L)

    xb = jnp.moveaxis(x[..., : T * L].reshape(*x.shape[:-1], T, L), -2, 0)  # [T, ..., M, L]
    fb = jnp.moveaxis(far_end[..., : T * L].reshape(*far_end.shape[:-1], T, L), -2, 0)

    state = full_stack_init(cfg, coeffs_np, batch_shape=x.shape[:-2], dtype=x.dtype)
    _, (out, kws_clean, p) = jax.lax.scan(
        lambda s, blk: full_stack_step(cfg, coeffs, s, blk[0], blk[1]), state, (xb, fb),
        unroll=unroll,
    )
    out = jnp.moveaxis(out, 0, -2).reshape(*x.shape[:-2], T * L)
    kws_clean = jnp.moveaxis(kws_clean, 0, -2).reshape(*x.shape[:-2], T * L)
    return out, kws_clean, jnp.moveaxis(p, 0, -2)
