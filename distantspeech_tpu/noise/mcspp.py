"""Full multichannel SPP noise tracker (Souden 2011 production variant).

Oracle: McSpp.estimation / estimation_core
(/root/reference/DistantSpeech/noise_estimation/mcspp.py:201-310).
On top of the base Gaussian-model SPP this adds the behaviours that make the
reference variant robust in production, all reproduced exactly:

- q from the CDR estimator: ``q = 1 - mccdr(y)`` (mcspp.py:116-117; the
  MCRA-based q and its clipping are dead code because the overwrite follows
  the clip);
- **adaptive diagonal loading** from the mid-band mean of q
  (mcspp.py:257-265): high estimated absence => heavier loading;
- warm-start: for the first 10 frames ``Phi_vv = Phi_yy`` and q is pinned to
  0.99 (mcspp.py:276-278);
- hermitian forcing of Phi_vv at the head of the core (mcspp.py:214) — note
  the reference mutates its carried Phi_vv here, so the noise recursion that
  follows consumes the *hermitized* matrix;
- negative-xi repair: bins with xi < 0 get their inverse recomputed from
  Phi_yy (+diag for the first 5 frames) (mcspp.py:222-229);
- complex covariance inverses (unlike the real-part base method);
- PMWF weights with beta = 10 (mcspp.py:285).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from distantspeech_tpu.stats.linalg import gauss_jordan_inv, matvec, trace_mm, vecmat

from distantspeech_tpu.noise.mccdr import McCdrConfig, McCdrState, mccdr_init, mccdr_step
from distantspeech_tpu.noise.mcspp_base import McSppOut


@dataclasses.dataclass(frozen=True)
class McSppConfig:
    nfft: int = 256
    n_channels: int = 4
    alpha: float = 0.92  # Phi_yy pole (mcspp.py:64-65)
    alpha_d: float = 0.92  # noise pole
    diag_min: float = 1e-4  # adaptive loading range (mcspp.py:258-259)
    diag_max: float = 1e-1
    warmup_frames: int = 10
    repair_frames: int = 5
    pmwf_beta: float = 10.0

    @property
    def half_bin(self) -> int:
        return self.nfft // 2 + 1

    @property
    def mccdr(self) -> McCdrConfig:
        # McSpp always builds McCDR with its 4-channel default (mcspp.py:54)
        # — with MORE channels the reference crashes outright (its [4,4,F]
        # Phi_yy cannot absorb a CxC outer product); we keep the 4-channel
        # CDR track and feed it the first 4 channels (mcspp_step), which is
        # bit-identical at C == 4 and defined for any C
        return McCdrConfig(nfft=self.nfft, n_channels=min(4, self.n_channels))

    @property
    def qband(self) -> Tuple[int, int]:
        """Mid-band bins whose mean q drives the loading (mcspp.py:262-264)."""
        return int(500 * self.nfft / 16000), int(2000 * self.nfft / 16000)


class McSppState(NamedTuple):
    Phi_yy: jnp.ndarray  # [..., F, C, C] complex
    Phi_vv: jnp.ndarray  # [..., F, C, C] complex
    mccdr: McCdrState
    frm_cnt: jnp.ndarray  # scalar int32


def mcspp_init(cfg: McSppConfig, batch_shape=(), cdtype=jnp.complex64) -> McSppState:
    F, C = cfg.half_bin, cfg.n_channels
    z = jnp.zeros((*batch_shape, F, C, C), dtype=cdtype)
    return McSppState(
        Phi_yy=z,
        Phi_vv=z,
        mccdr=mccdr_init(cfg.mccdr, batch_shape, cdtype=cdtype),
        frm_cnt=jnp.asarray(0, jnp.int32),
    )


def mcspp_step(
    cfg: McSppConfig, Fn: jnp.ndarray, state: McSppState, y: jnp.ndarray
) -> Tuple[McSppState, McSppOut]:
    """One frame.  Fn: [F] diffuse pair coherence (cfg.mccdr.fn_pair());
    y: [..., F, C] complex.  Returns (new_state, McSppOut)."""
    C = y.shape[-1]
    eye = jnp.eye(C, dtype=y.dtype)
    warm = state.frm_cnt < cfg.warmup_frames

    mccdr_state, cdr_p = mccdr_step(cfg.mccdr, Fn, state.mccdr, y[..., : cfg.mccdr.n_channels])
    q = 1.0 - cdr_p  # mcspp.py:116-117

    lo, hi = cfg.qband
    q_avg = jnp.mean(q[..., lo:hi], axis=-1)
    diag_value = q_avg * cfg.diag_max + (1.0 - q_avg) * cfg.diag_min  # [...]
    diag = diag_value[..., None, None, None] * eye  # broadcast over bins

    psd_yy = y[..., :, None] * jnp.conj(y)[..., None, :]
    Phi_yy = cfg.alpha * state.Phi_yy + (1.0 - cfg.alpha) * psd_yy

    Phi_vv = jnp.where(warm, Phi_yy, state.Phi_vv)  # mcspp.py:276-277
    q = jnp.where(warm, jnp.full_like(q, 0.99), q)  # mcspp.py:278

    # ---- estimation_core (mcspp.py:201-245) --------------------------------
    Phi_vv = 0.5 * (Phi_vv + jnp.conj(jnp.swapaxes(Phi_vv, -1, -2)))  # :214
    Phi_xx = Phi_yy - Phi_vv
    Pinv = gauss_jordan_inv(Phi_vv + diag)

    # traces / quadratic forms as multiply-reduce: batched CxC dot_generals
    # are per-bin matmul dispatches (see stats.linalg.matvec)
    xi = jnp.real(trace_mm(Pinv, Phi_yy)) - C
    neg = xi < 0.0  # [..., F]
    # one repair inverse, not two: inv(Phi_yy + diag*1[frm_cnt<rf]) selects
    # the same branch values bit-exactly (diag*0 == 0, A + 0 == A) while
    # halving the repair's Gauss-Jordan work (the inverses dominate the
    # McSpp frame)
    rep_gate = jnp.where(state.frm_cnt < cfg.repair_frames, 1.0, 0.0)
    repair = gauss_jordan_inv(Phi_yy + rep_gate * diag)
    Pinv = jnp.where(neg[..., None, None], repair, Pinv)
    xi = jnp.real(trace_mm(Pinv, Phi_yy)) - C
    xi = jnp.clip(xi, 1e-6, 1e8)

    # literal y^H Pinv Phi_yy Pinv y - y^H Pinv y (no hermitian assumption on Pinv)
    lv = vecmat(jnp.conj(y), Pinv)  # y^H Pinv
    rv = matvec(Pinv, y)  # Pinv y
    gamma = jnp.real(
        jnp.sum(lv * matvec(Phi_yy, rv), axis=-1) - jnp.sum(lv * y, axis=-1)
    )
    gamma = jnp.clip(gamma, 1e-6, 1e8)

    # q == 1.0 is reachable in float32 (cdr_p underflows to 0 in low-energy
    # bins): q/(1-q) is then inf and inf * exp(-huge) = NaN, which the
    # synthesis matmuls smear across the whole block.  The mathematical
    # limit as q -> 1 is p -> 0; bits are unchanged for q < 1 (float64
    # never reaches 1.0 here, so reference parity is untouched).
    ratio = q / (1.0 - q) * (1.0 + xi) * jnp.exp(-(gamma / (1.0 + xi)))
    p = jnp.where(q >= 1.0, 0.0, 1.0 / (1.0 + ratio))
    p = jnp.clip(p, 0.0, 1.0)

    # ---- noise update (mcspp.py:281, McSppBase.update_noise_psd) -----------
    alpha_tilde = (cfg.alpha_d + (1.0 - cfg.alpha_d) * p)[..., None, None]
    Phi_vv_new = alpha_tilde * Phi_vv + (1.0 - alpha_tilde) * psd_yy

    # ---- PMWF weights, beta = 10 (mcspp.py:285) ----------------------------
    w = matvec(Pinv, Phi_xx[..., :, 0]) / (cfg.pmwf_beta + xi)[..., None]

    new_state = McSppState(Phi_yy=Phi_yy, Phi_vv=Phi_vv_new, mccdr=mccdr_state, frm_cnt=state.frm_cnt + 1)
    return new_state, McSppOut(p=p, q=q, xi=xi, gamma=gamma, w=w)


def mcspp_run(cfg: McSppConfig, Y_tf: jnp.ndarray) -> McSppOut:
    """Scan over frames.  Y_tf: [T, ..., F, C] complex -> McSppOut [T, ...]."""
    Fn = jnp.asarray(cfg.mccdr.fn_pair(), dtype=Y_tf.real.dtype)
    state = mcspp_init(cfg, batch_shape=Y_tf.shape[1:-2], cdtype=Y_tf.dtype)
    _, outs = jax.lax.scan(lambda s, y: mcspp_step(cfg, Fn, s, y), state, Y_tf)
    return outs
