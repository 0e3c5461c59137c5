"""MC-MCRA: multichannel MCRA with local/global absence statistics (Souden'11).

Oracle: McMcra.estimation
(/root/reference/DistantSpeech/noise_estimation/mc_mcra.py:180-225).  The
reference keeps REAL-valued spatial covariances (np.real of the outer
product, mc_mcra.py:184-186) in [C, C, F] layout; we keep the same real math
in [F, C, C].  The a-priori absence q is the *local* statistic only — the
global / frame statistics are computed but not applied (mc_mcra.py:138-141),
so they are omitted here.

Per-bin ψ / ψ̃ thresholds (compute_q_local, mc_mcra.py:91-105):
    psi >= 100 or psi_tilde > 100     -> q = 0.01
    elif psi_tilde < M                -> q = 0.99
    else  (100 - psi_tilde)/(100 - M)  clipped to [0.01, 0.99]
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from distantspeech_tpu.stats.linalg import gauss_jordan_inv


@dataclasses.dataclass(frozen=True)
class McMcraConfig:
    nfft: int = 256
    n_channels: int = 4
    alpha: float = 0.92  # Phi_yy pole (mc_mcra.py:37)
    alpha_d: float = 0.95  # noise pole (mc_mcra.py:35)
    diag: float = 1e-6
    rel_diag: float = 0.0  # extra loading scaled by tr(Phi_vv)/C.  0 matches
    # the reference (mc_mcra.py:191, absolute 1e-6 in float64); in float32 a
    # single-snapshot Phi_vv is rank-1 with condition |y|^2/1e-6 and its
    # inverse goes non-finite during warmup — ~1e-5 bounds the condition at
    # ~1/rel_diag, safe for complex64 device execution.
    psi_0: float = 100.0
    psi_tilde_0: float = 100.0
    q_min: float = 0.01
    q_max: float = 0.99
    warmup_frames: int = 5
    gmin: float = 0.0631

    @property
    def half_bin(self) -> int:
        return self.nfft // 2 + 1


class McMcraState(NamedTuple):
    Phi_yy: jnp.ndarray  # [..., F, C, C] real
    Phi_vv: jnp.ndarray  # [..., F, C, C] real
    frm_cnt: jnp.ndarray  # scalar int32


class McMcraOut(NamedTuple):
    p: jnp.ndarray  # [..., F]
    q: jnp.ndarray  # [..., F] (local statistic)
    xi: jnp.ndarray  # [..., F]
    gamma: jnp.ndarray  # [..., F]
    G: jnp.ndarray  # [..., F] OM-LSA style gain


def mc_mcra_init(cfg: McMcraConfig, batch_shape=(), dtype=jnp.float32) -> McMcraState:
    F, C = cfg.half_bin, cfg.n_channels
    z = jnp.zeros((*batch_shape, F, C, C), dtype=dtype)
    return McMcraState(Phi_yy=z, Phi_vv=z, frm_cnt=jnp.asarray(0, jnp.int32))


def mc_mcra_step(cfg: McMcraConfig, state: McMcraState, y: jnp.ndarray) -> Tuple[McMcraState, McMcraOut]:
    """One frame.  y: [..., F, C] complex spectrum."""
    C = y.shape[-1]
    rdtype = state.Phi_yy.dtype
    eye = jnp.eye(C, dtype=rdtype)

    # real part of the outer product (symmetric, mc_mcra.py:184-186)
    outer = jnp.real(y[..., :, None] * jnp.conj(y)[..., None, :]).astype(rdtype)
    Phi_yy = cfg.alpha * state.Phi_yy + (1.0 - cfg.alpha) * outer
    Phi_vv = jnp.where(state.frm_cnt < cfg.warmup_frames, Phi_yy, state.Phi_vv)
    Phi_xx = Phi_yy - Phi_vv

    load = cfg.diag
    if cfg.rel_diag:
        tr = jnp.trace(Phi_vv, axis1=-2, axis2=-1) / C
        load = cfg.diag + cfg.rel_diag * tr[..., None, None]
    Pinv = gauss_jordan_inv(Phi_vv + load * eye)

    # All downstream uses of Pinv are traces / quadratic forms over CxC
    # matrices.  Batched [.., F, C, C] dot_generals with a tiny contraction
    # become per-bin matmul dispatches (see stats/linalg.py);
    # broadcast-multiply-reduce keeps the whole step elementwise and
    # fusible.  Identical math:
    #   tr(Pinv @ Phi_yy)            = sum_ij Pinv_ij * Phi_yy_ji
    #   y^T Pinv conj(y)             = sum_i y_i conj(v_i),  v = Pinv y
    #   conj(y)^T Pinv Phi_xx Pinv y = conj(v)^T (Phi_xx v)  — equal only up
    #   to rounding: gauss_jordan_inv of a symmetric Pn is symmetric to float
    #   rounding, not exactly, so this differs from the literal two-sided
    #   form at the last few ulps (parity tests pass in float64)
    psi_tilde = jnp.sum(Pinv * jnp.swapaxes(Phi_yy, -1, -2), axis=(-2, -1))
    xi = jnp.clip(psi_tilde - C, 1e-6, 1e6)

    v = jnp.sum(Pinv * y[..., None, :], axis=-1)  # [..., F, C] = Pinv @ y
    Pxv = jnp.sum(Phi_xx * v[..., None, :], axis=-1)  # Phi_xx @ v
    gamma = jnp.clip(jnp.real(jnp.sum(jnp.conj(v) * Pxv, axis=-1)), 1e-6, 1e6)

    # local absence statistic (compute_q_local)
    psi = jnp.real(jnp.sum(y * jnp.conj(v), axis=-1))
    q_mid = jnp.clip((cfg.psi_tilde_0 - psi_tilde) / (cfg.psi_tilde_0 - C), cfg.q_min, cfg.q_max)
    q = jnp.where(
        (psi >= cfg.psi_0) | (psi_tilde > cfg.psi_tilde_0),
        cfg.q_min,
        jnp.where(psi_tilde < C, cfg.q_max, q_mid),
    )

    p = 1.0 / (1.0 + q / (1.0 - q) * (1.0 + xi) * jnp.exp(-(gamma / (1.0 + xi))))
    p = jnp.clip(p, 0.01, 0.99)

    alpha_tilde = (cfg.alpha_d + (1.0 - cfg.alpha_d) * p)[..., None, None]
    Phi_vv_new = alpha_tilde * Phi_vv + (1.0 - alpha_tilde) * outer

    # OM-LSA gain with the first two bins zeroed (compute_weight, mc_mcra.py:155-160)
    G_H1 = xi / (1.0 + xi)
    G = jnp.clip(G_H1**p * cfg.gmin ** (1.0 - p), cfg.gmin, 1.0)
    G = G.at[..., :2].set(0.0)

    new_state = McMcraState(Phi_yy=Phi_yy, Phi_vv=Phi_vv_new, frm_cnt=state.frm_cnt + 1)
    return new_state, McMcraOut(p=p, q=q, xi=xi, gamma=gamma, G=G)


def mc_mcra_run(cfg: McMcraConfig, Y_tf: jnp.ndarray) -> McMcraOut:
    """Scan over frames.  Y_tf: [T, ..., F, C] complex."""
    rdtype = Y_tf.real.dtype
    state = mc_mcra_init(cfg, batch_shape=Y_tf.shape[1:-2], dtype=rdtype)
    _, outs = jax.lax.scan(lambda s, y: mc_mcra_step(cfg, s, y), state, Y_tf)
    return outs
