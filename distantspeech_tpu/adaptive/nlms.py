"""Time-domain sample-serial adaptive filters: (N)LMS, block LMS, RLS.

Oracles: BaseFilter.update (/root/reference/DistantSpeech/adaptivefilter/
BaseFilter.py:44-85), BlockLms.update (BlockLMS.py:32-56), Rls.update
(RLS.py:26-45).

These recursions are serial by definition (each sample's gradient uses the
weights updated by the previous sample), so the frame axis is a ``lax.scan``;
the win here over the reference is that the per-sample work is a fused
tensor op (and arbitrarily many independent filters batch over leading
axes).  The frequency-domain FLMS (``adaptive.flms``) is the batched
choice for long filters; these exist for capability parity and as oracles
for the block variants.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from distantspeech_tpu.stats.linalg import matvec, vecmat


def awgn(x, snr: float, seed: int = 7):
    """Add white Gaussian noise at a given SNR in dB (reference ``awgn``,
    BaseFilter.py:9-21 — same legacy-NumPy RNG so outputs match exactly).

    Host-side test/demo utility; x: [N] numpy array."""
    import numpy as np

    rs = np.random.RandomState(seed)
    lin = 10.0 ** (snr / 10.0)
    xpower = np.sum(np.asarray(x) ** 2) / len(x)
    noise = rs.randn(len(x)) * np.sqrt(xpower / lin)
    return np.asarray(x) + noise


class NlmsState(NamedTuple):
    w: jnp.ndarray  # [..., L]
    buf: jnp.ndarray  # input shift register [..., L], newest first


def nlms_init(filter_len: int, batch_shape=(), dtype=jnp.float32) -> NlmsState:
    z = jnp.zeros((*batch_shape, filter_len), dtype=dtype)
    return NlmsState(w=z, buf=z)


def nlms_step(
    state: NlmsState, x_n: jnp.ndarray, d_n: jnp.ndarray, mu: float = 0.1,
    eps: float = 1e-4, p=1.0, normalize: bool = True,
) -> Tuple[NlmsState, jnp.ndarray]:
    """One sample of (N)LMS.  x_n, d_n: [...] scalars per batch element."""
    buf = jnp.concatenate([x_n[..., None], state.buf[..., :-1]], axis=-1)
    # multiply-reduce over the tap axis (see stats.linalg.matvec)
    err = d_n - jnp.sum(state.w * buf, axis=-1)
    if normalize:
        grad = buf * err[..., None] / (jnp.sum(buf * buf, axis=-1) + eps)[..., None]
    else:
        grad = buf * err[..., None]
    w = state.w + 2.0 * p * mu * grad
    return NlmsState(w=w, buf=buf), err


def nlms_filter(
    x: jnp.ndarray, d: jnp.ndarray, filter_len: int, mu: float = 0.1, normalize: bool = True
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Run (N)LMS over whole signals.  x, d: [..., N] (time axis last).

    Returns (err [..., N], w [..., L]) — matches BaseFilter.filter.
    """
    state = nlms_init(filter_len, batch_shape=x.shape[:-1], dtype=x.dtype)
    xt = jnp.moveaxis(x, -1, 0)
    dt = jnp.moveaxis(d, -1, 0)
    state, errs = jax.lax.scan(
        lambda s, xd: nlms_step(s, xd[0], xd[1], mu=mu, normalize=normalize), state, (xt, dt)
    )
    return jnp.moveaxis(errs, 0, -1), state.w


class BlockLmsState(NamedTuple):
    w: jnp.ndarray  # [..., L]
    buf: jnp.ndarray  # input shift register  [..., L]
    X: jnp.ndarray  # block input matrix      [..., B, L], newest row first
    e: jnp.ndarray  # block error vector      [..., B]
    counter: jnp.ndarray  # scalar int32


def block_lms_init(filter_len: int, block_len: int, batch_shape=(), dtype=jnp.float32) -> BlockLmsState:
    z = jnp.zeros((*batch_shape, filter_len), dtype=dtype)
    return BlockLmsState(
        w=z,
        buf=z,
        X=jnp.zeros((*batch_shape, block_len, filter_len), dtype=dtype),
        e=jnp.zeros((*batch_shape, block_len), dtype=dtype),
        counter=jnp.asarray(0, jnp.int32),
    )


def block_lms_step(
    state: BlockLmsState, x_n: jnp.ndarray, d_n: jnp.ndarray, mu: float = 0.1, alpha: float = 1e-4
) -> Tuple[BlockLmsState, jnp.ndarray]:
    """One sample of block LMS (weights update every block_len samples,
    BlockLMS.py:32-56)."""
    B = state.e.shape[-1]
    buf = jnp.concatenate([x_n[..., None], state.buf[..., :-1]], axis=-1)
    X = jnp.concatenate([buf[..., None, :], state.X[..., :-1, :]], axis=-2)
    en = d_n - jnp.sum(state.w * buf, axis=-1)
    e = jnp.concatenate([en[..., None], state.e[..., :-1]], axis=-1)

    norm = jnp.sum(X**2, axis=-1) + alpha  # [..., B]
    grad = jnp.sum(X * (e / norm)[..., :, None], axis=-2)
    do_update = (state.counter % B) == 0
    w = jnp.where(do_update, state.w + 2.0 * mu * grad, state.w)
    counter = jnp.where(do_update, jnp.asarray(0, jnp.int32), state.counter) + 1
    return BlockLmsState(w=w, buf=buf, X=X, e=e, counter=counter), en


class RlsState(NamedTuple):
    w: jnp.ndarray  # [..., L]
    buf: jnp.ndarray  # [..., L]
    P: jnp.ndarray  # inverse correlation [..., L, L]


def rls_init(filter_len: int, delta: float = 1e-3, batch_shape=(), dtype=jnp.float32) -> RlsState:
    z = jnp.zeros((*batch_shape, filter_len), dtype=dtype)
    P = jnp.broadcast_to(jnp.eye(filter_len, dtype=dtype) / delta, (*batch_shape, filter_len, filter_len))
    return RlsState(w=z, buf=z, P=P)


def rls_step(
    state: RlsState, x_n: jnp.ndarray, d_n: jnp.ndarray, mu: float = 0.5, lam: float = 0.9998
) -> Tuple[RlsState, jnp.ndarray]:
    """One RLS sample (RLS.py:26-45; note the reference scales the gradient
    by 2*mu through update_coef, so mu=0.5 gives the textbook recursion)."""
    buf = jnp.concatenate([x_n[..., None], state.buf[..., :-1]], axis=-1)
    err = d_n - jnp.sum(state.w * buf, axis=-1)
    num = matvec(state.P, buf)  # P u
    kn = num / (lam + jnp.sum(buf * num, axis=-1))[..., None]
    row = vecmat(buf, state.P)  # u^T P (no symmetry assumption)
    P = (state.P - kn[..., :, None] * row[..., None, :]) / lam
    w = state.w + 2.0 * mu * err[..., None] * kn
    return RlsState(w=w, buf=buf, P=P), err


def rls_filter(x: jnp.ndarray, d: jnp.ndarray, filter_len: int, mu: float = 0.5, lam: float = 0.9998):
    """Run RLS over whole signals, time axis last."""
    state = rls_init(filter_len, batch_shape=x.shape[:-1], dtype=x.dtype)
    state, errs = jax.lax.scan(
        lambda s, xd: rls_step(s, xd[0], xd[1], mu=mu, lam=lam),
        state,
        (jnp.moveaxis(x, -1, 0), jnp.moveaxis(d, -1, 0)),
    )
    return jnp.moveaxis(errs, 0, -1), state.w
