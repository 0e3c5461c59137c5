"""Gaussian-model multichannel speech presence probability (Souden 2010).

Oracle: McSppBase.estimation
(/root/reference/DistantSpeech/noise_estimation/mcspp_base.py:262-297) with
its helpers estimate_noisy_psd (:84-90), compute_q (:98-122, MCRA-driven),
compute_p (:124-139) and update_noise_psd (:299-325).

The reference is already bin-vectorised NumPy; this is the same math as a
pure scan step with one deliberate trait kept: the base method works on the
REAL part of the covariances for the inverse / xi / gamma statistics
("for base method, we use real type for saving computation",
mcspp_base.py:262-297), while Phi_yy / Phi_vv themselves stay complex.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from distantspeech_tpu.stats.linalg import gauss_jordan_inv, matvec, trace_mm, vecmat

from distantspeech_tpu.noise.mcra import McraConfig, McraState, mcra_init, mcra_step


@dataclasses.dataclass(frozen=True)
class McSppBaseConfig:
    nfft: int = 256
    n_channels: int = 4
    alpha: float = 0.92  # Phi_yy smoothing (mcspp_base.py:41)
    alpha_d: float = 0.92  # noise pole (mcspp_base.py:38)
    diag: float = 1e-6  # diagonal loading (mcspp_base.py:77)
    q_min: float = 0.01
    q_max: float = 0.99
    p_min: float = 0.01
    p_max: float = 0.99
    pmwf_beta: float = 1.0

    @property
    def half_bin(self) -> int:
        return self.nfft // 2 + 1

    @property
    def mcra(self) -> McraConfig:
        return McraConfig(nfft=self.nfft, L=15)  # mcspp_base.py:78-79


class McSppBaseState(NamedTuple):
    Phi_yy: jnp.ndarray  # [..., F, C, C] complex
    Phi_vv: jnp.ndarray  # [..., F, C, C] complex
    p: jnp.ndarray  # [..., F]
    mcra: McraState


class McSppOut(NamedTuple):
    p: jnp.ndarray  # [..., F] speech presence
    q: jnp.ndarray  # [..., F] a-priori absence
    xi: jnp.ndarray  # [..., F] prior SNR statistic
    gamma: jnp.ndarray  # [..., F] posterior statistic
    w: jnp.ndarray  # [..., F, C] PMWF weights


def mcspp_base_init(cfg: McSppBaseConfig, batch_shape=(), cdtype=jnp.complex64) -> McSppBaseState:
    F, C = cfg.half_bin, cfg.n_channels
    z = jnp.zeros((*batch_shape, F, C, C), dtype=cdtype)
    rdtype = jnp.zeros(0, dtype=cdtype).real.dtype
    return McSppBaseState(
        Phi_yy=z,
        Phi_vv=z,
        p=jnp.zeros((*batch_shape, F), dtype=rdtype),
        mcra=mcra_init(cfg.mcra, batch_shape, dtype=rdtype),
    )


def mcspp_base_step(cfg: McSppBaseConfig, state: McSppBaseState, y: jnp.ndarray) -> Tuple[McSppBaseState, McSppOut]:
    """One MC-SPP frame.  y: [..., F, C] complex multichannel spectrum."""
    C = y.shape[-1]
    psd_yy = y[..., :, None] * jnp.conj(y)[..., None, :]  # [..., F, C, C]
    Phi_yy = cfg.alpha * state.Phi_yy + (1.0 - cfg.alpha) * psd_yy

    Phi_xx = Phi_yy - state.Phi_vv

    eye = jnp.eye(C, dtype=psd_yy.real.dtype)
    Pinv = gauss_jordan_inv(state.Phi_vv.real + cfg.diag * eye)  # real (mcspp_base.py:274)

    # traces / quadratic forms as multiply-reduce: batched CxC dot_generals
    # are per-bin matmul dispatches (see stats.linalg.matvec)
    xi = trace_mm(Pinv, Phi_xx.real)
    # gamma = y^H Pinv Phi_xx Pinv y   on real matrices (mcspp_base.py:278-280)
    lv = vecmat(jnp.conj(y), Pinv)  # y^H Pinv
    rv = matvec(Pinv, y)  # Pinv y
    gamma = jnp.real(jnp.sum(lv * matvec(Phi_xx.real, rv), axis=-1))
    xi = jnp.clip(xi, 1e-6, 1e6)
    gamma = jnp.clip(gamma, 1e-6, 1e6)

    # q from MCRA on the reference channel (compute_q, mcspp_base.py:98-122)
    power = jnp.abs(y[..., 0] * jnp.conj(y[..., 0]))
    mcra_state, (_, p_mcra) = mcra_step(cfg.mcra, state.mcra, power)
    q = jnp.clip(jnp.sqrt(1.0 - p_mcra), cfg.q_min, cfg.q_max)

    # posterior SPP (compute_p with alpha_p=0, mcspp_base.py:124-139)
    p = 1.0 / (1.0 + q / (1.0 - q) * (1.0 + xi) * jnp.exp(-(gamma / (1.0 + xi))))
    p = jnp.clip(p, cfg.p_min, cfg.p_max)

    # SPP-weighted noise covariance update (update_noise_psd, mcspp_base.py:299-325)
    alpha_tilde = (cfg.alpha_d + (1.0 - cfg.alpha_d) * p)[..., None, None]
    Phi_vv = alpha_tilde * state.Phi_vv + (1.0 - alpha_tilde) * psd_yy

    # PMWF weights w = (Pinv Phi_xx u) / (beta + xi)  (compute_pmwf_weight :220)
    w = matvec(Pinv, Phi_xx[..., :, 0]) / (cfg.pmwf_beta + xi)[..., None]

    new_state = McSppBaseState(Phi_yy=Phi_yy, Phi_vv=Phi_vv, p=p, mcra=mcra_state)
    return new_state, McSppOut(p=p, q=q, xi=xi, gamma=gamma, w=w)


def mcspp_base_run(cfg: McSppBaseConfig, Y_tf: jnp.ndarray) -> McSppOut:
    """Scan over frames.  Y_tf: [T, ..., F, C] -> McSppOut of [T, ...] arrays."""
    state = mcspp_base_init(cfg, batch_shape=Y_tf.shape[1:-2], cdtype=Y_tf.dtype)
    _, outs = jax.lax.scan(lambda s, y: mcspp_base_step(cfg, s, y), state, Y_tf)
    return outs
