"""Complex subband adaptive filters: per-bin NLMS (1ch / multichannel) and RLS.

Oracles: SubbandLMS.update (/root/reference/DistantSpeech/adaptivefilter/
SubbandLMS.py:28-88), SubbandLmsMc.update (SubbandLmsMc.py:144-191),
SubbandRLS.update (SubbandRLS.py:44-95).  All operate on one frame of
subband coefficients at a time with a per-bin tap delay line; every per-bin
quantity batches over ``[..., F]`` so a frame is one fused tensor op, and
the ``[..., F, N, N]`` RLS inverse-correlation recursion runs as
elementwise multiply-reduce (tiny batched contractions become many tiny
matmuls otherwise — see stats.linalg.matvec).

Frequency-domain inputs only: the reference's optional time-domain entry
(SubbandAF.update_input_data, SubbandAF.py:53-64) is a convenience wrapper
around its STFT ``Transform``; compose with ``distantspeech_tpu.transform``
explicitly instead.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp

from distantspeech_tpu.stats.linalg import matvec, vecmat


@dataclasses.dataclass(frozen=True)
class SubbandAfConfig:
    num_bands: int = 512  # n_fft of the analysis transform
    filter_len: int = 2  # taps per bin
    n_channels: int = 1
    mu: float = 0.1
    alpha: float = 0.9  # power-estimate pole
    normalize: bool = True
    forgetting_factor: float = 0.998  # RLS lambda (SubbandRLS.py:17)

    @property
    def half_bin(self) -> int:
        return self.num_bands // 2 + 1


class SubbandLmsState(NamedTuple):
    W: jnp.ndarray  # [..., F, N] (or [..., F, N, C] multichannel)
    buf: jnp.ndarray  # tap delay line, same shape as W
    P: jnp.ndarray  # [..., F] power estimate


def subband_lms_init(cfg: SubbandAfConfig, batch_shape=(), cdtype=jnp.complex64) -> SubbandLmsState:
    F, N, C = cfg.half_bin, cfg.filter_len, cfg.n_channels
    shape = (*batch_shape, F, N) if C == 1 else (*batch_shape, F, N, C)
    z = jnp.zeros(shape, dtype=cdtype)
    rdtype = jnp.zeros(0, dtype=cdtype).real.dtype
    return SubbandLmsState(W=z, buf=z, P=jnp.zeros((*batch_shape, F), dtype=rdtype))


def subband_lms_step(
    cfg: SubbandAfConfig, state: SubbandLmsState, x: jnp.ndarray, d: jnp.ndarray,
    eps: float = 1e-4, p: Optional[jnp.ndarray] = None,
) -> Tuple[SubbandLmsState, jnp.ndarray]:
    """One frame of single-channel subband NLMS.

    x, d: [..., F] complex subband frames.  ``p`` gates both the output
    (err = d - y*p, SubbandLMS.py:66-69) and the weight update.
    Returns (new_state, err [..., F]).
    """
    buf = jnp.concatenate([x[..., None], state.buf[..., :-1]], axis=-1)
    # multiply-reduce over the tiny tap axis (see stats.linalg.matvec)
    y = jnp.sum(jnp.conj(state.W) * buf, axis=-1)
    pv = jnp.ones_like(d.real) if p is None else p
    err = d - y * pv

    if cfg.normalize:
        P = cfg.alpha * state.P + (1.0 - cfg.alpha) * jnp.sum(jnp.real(jnp.conj(buf) * buf), axis=-1)
        grad = buf * jnp.conj(err)[..., None] / (P + eps)[..., None]
    else:
        P = state.P
        grad = buf * jnp.conj(err)[..., None]
    W = state.W + 2.0 * cfg.mu * grad * pv[..., None]
    return SubbandLmsState(W=W, buf=buf, P=P), err


def subband_lms_mc_step(
    cfg: SubbandAfConfig, state: SubbandLmsState, x: jnp.ndarray, d: jnp.ndarray,
    eps: float = 1e-4, p: Optional[jnp.ndarray] = None,
) -> Tuple[SubbandLmsState, jnp.ndarray]:
    """One frame of multichannel subband NLMS (the GSC AIC filter).

    x: [..., F, C]; d: [..., F].  Power normalisation averages over channels
    (SubbandLmsMc.py:175-181).  Returns (new_state, err [..., F]).
    """
    buf = jnp.concatenate([x[..., None, :], state.buf[..., :-1, :]], axis=-2)  # [..., F, N, C]
    y = jnp.sum(jnp.conj(state.W) * buf, axis=(-2, -1))
    pv = jnp.ones_like(d.real) if p is None else p
    err = d - y * pv

    if cfg.normalize:
        P = cfg.alpha * state.P + (1.0 - cfg.alpha) * jnp.sum(
            jnp.real(jnp.conj(buf) * buf), axis=(-2, -1)
        ) / cfg.n_channels
        grad = buf * jnp.conj(err)[..., None, None] / (P + eps)[..., None, None]
    else:
        P = state.P
        grad = buf * jnp.conj(err)[..., None, None]
    W = state.W + 2.0 * cfg.mu * grad * pv[..., None, None]
    return SubbandLmsState(W=W, buf=buf, P=P), err


class SubbandRlsState(NamedTuple):
    W: jnp.ndarray  # [..., F, N]
    buf: jnp.ndarray  # [..., F, N]
    P: jnp.ndarray  # inverse correlation [..., F, N, N]


def subband_rls_init(cfg: SubbandAfConfig, batch_shape=(), cdtype=jnp.complex64, delta: float = 1e-3) -> SubbandRlsState:
    F, N = cfg.half_bin, cfg.filter_len
    z = jnp.zeros((*batch_shape, F, N), dtype=cdtype)
    P = jnp.broadcast_to(jnp.eye(N, dtype=cdtype) / delta, (*batch_shape, F, N, N))
    return SubbandRlsState(W=z, buf=z, P=P)


def subband_rls_step(
    cfg: SubbandAfConfig, state: SubbandRlsState, x: jnp.ndarray, d: jnp.ndarray, mu: float = 0.5
) -> Tuple[SubbandRlsState, jnp.ndarray]:
    """One frame of per-bin RLS (SubbandRLS.py:44-95).

    x, d: [..., F] complex.  The [..., F, N, N] P-recursion is a batched
    rank-1 matmul update.  Returns (new_state, err [..., F]).
    """
    lam = cfg.forgetting_factor
    buf = jnp.concatenate([x[..., None], state.buf[..., :-1]], axis=-1)
    y = jnp.sum(jnp.conj(state.W) * buf, axis=-1)
    err = d - y

    num = matvec(state.P, buf)  # P u
    den = lam + jnp.sum(jnp.conj(buf) * num, axis=-1)
    kn = num / den[..., None]
    # P <- (P - kn u^H P) / lam   (SubbandRLS.py:63)
    uhP = vecmat(jnp.conj(buf), state.P)
    P = (state.P - kn[..., :, None] * uhP[..., None, :]) / lam

    W = state.W + 2.0 * mu * jnp.conj(err)[..., None] * kn
    return SubbandRlsState(W=W, buf=buf, P=P), err
