"""Online adaptive MVDR beamformer with MCRA-gated noise-covariance updates.

Oracle: adaptivebeamfomer.process with method='MVDR'
(/root/reference/DistantSpeech/beamformer/adaptivebeamformer.py:44-128).
The reference runs a Python ``frames x bins`` double loop doing one M x M
inverse per (frame, bin); here one frame is a single vectorised step over all
bins (and any utterance batch), scanned over the frame axis:

- Ryy rank-1 recursion for every bin at once (adaptivebeamformer.py:86-88);
- the MCRA VAD gate ``p[k] < 0.4`` becomes a per-bin mask selecting between
  the updated and held noise state (adaptivebeamformer.py:94-104; computed
  for all bins, masked into the carry — cheaper on a vector machine than
  data-dependent gathering of "bins to update");
- the reference's explicit inverse becomes a batched unrolled LDL^H solve
  against the steering vector (``stats.linalg.ldl_solve``) — MVDR only ever
  consumes R^-1 a, so the carried state is the M-vector u, not M x M;
- MVDR output w^H Z = (u^H Z) / conj(a^H u) for all bins in one einsum.

Like the reference, covariances start at zero and the first frame's MCRA
p == p_min < 0.4 updates every bin, so no NaN weights ever reach the output.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from distantspeech_tpu.array.geometry import ArrayGeometry
from distantspeech_tpu.array.steering import steering_vector
from distantspeech_tpu.noise.mcra import McraConfig, McraState, mcra_init, mcra_step
from distantspeech_tpu.stats.psd import rank1_update
from distantspeech_tpu.stats.linalg import ldl_solve
from distantspeech_tpu.stats.weights import mvdr_weights
from distantspeech_tpu.transform import StftConfig, analysis, synthesis


@dataclasses.dataclass(frozen=True)
class MvdrConfig:
    stft: StftConfig = StftConfig(256, 128)
    alpha_y: float = 0.8  # Ryy smoothing (adaptivebeamformer.py:65)
    alpha_v: float = 0.9998  # Rvv smoothing (adaptivebeamformer.py:66)
    p_vad: float = 0.4  # MCRA gate (adaptivebeamformer.py:94)
    diag: float = 1e-6  # diagonal loading (adaptivebeamformer.py:89)
    rel_diag: float = 0.0  # extra loading scaled by tr(Rvv)/M; 0 matches the
    # reference exactly.  Set ~1e-5 for production robustness: a perfectly
    # coherent stationary source slips past the MCRA gate and drives Rvv
    # rank-1, and the complex64 inverse of a matrix conditioned worse than
    # ~1e7 emits non-finite weights (float64 reference merely degrades).
    mcra_L: int = 15  # minima window; 15 matches the reference MVDR default,
    # but real speech needs ~65 (0.5 s) or bursts leak into the noise floor
    # (the reference's own GSC pipelines use 60-65, TDGSC.py:44-45)
    vad_guard: bool = False  # additionally gate Rvv updates on MCRA's RAW
    # speech indicator S/Smin <= delta_s.  MCRA forces p = 0 for the first
    # 2L frames (mcra.py:68-69) so lambda_d converges, which leaves the
    # covariance gate wide open for ~1 s; on recordings that start mid-
    # speech the target is absorbed into Rvv (alpha_v memory ~5000 frames)
    # and self-cancelled for the rest of the utterance (measured -18 dB
    # SI-SDR on the real-speech mix, round 4).  The raw
    # indicator is exactly the statistic p is filtered from, minus the
    # warmup forcing.  Off by default: the reference has no such guard.

    @property
    def mcra(self) -> McraConfig:
        return McraConfig(nfft=self.stft.n_fft, L=self.mcra_L)


class MvdrState(NamedTuple):
    Ryy: jnp.ndarray  # [..., F, M, M]
    Rvv: jnp.ndarray  # [..., F, M, M]
    u: jnp.ndarray  # [..., F, M] — held solve (Rvv + diag I)^-1 a; the
    # reference holds the full inverse (adaptivebeamformer.py:103-104), but
    # MVDR only ever consumes inv @ steering, so carrying the M-vector is
    # mathematically identical and ~4x cheaper per frame (ldl_solve)
    mcra: McraState


def mvdr_init(cfg: MvdrConfig, n_mics: int, batch_shape=(), cdtype=jnp.complex64) -> MvdrState:
    F = cfg.stft.half_bin
    z = jnp.zeros((*batch_shape, F, n_mics, n_mics), dtype=cdtype)
    u = jnp.zeros((*batch_shape, F, n_mics), dtype=cdtype)
    rdtype = jnp.zeros(0, dtype=cdtype).real.dtype
    return MvdrState(Ryy=z, Rvv=z, u=u, mcra=mcra_init(cfg.mcra, batch_shape, dtype=rdtype))


def mvdr_step(
    cfg: MvdrConfig, steer: jnp.ndarray, state: MvdrState, Z: jnp.ndarray
) -> Tuple[MvdrState, jnp.ndarray]:
    """One frame of adaptive MVDR.

    steer: [F, M] steering vector; Z: [..., F, M] multichannel frame.
    Returns (new_state, Yf [..., F]).
    """
    power = jnp.real(Z[..., 0] * jnp.conj(Z[..., 0]))
    mcra_state, (_, p) = mcra_step(cfg.mcra, state.mcra, power)

    Ryy = rank1_update(state.Ryy, Z, cfg.alpha_y)

    update = p < cfg.p_vad  # [..., F]
    if cfg.vad_guard:
        Sr = mcra_state.S / (mcra_state.Smin + 1e-6)
        update = update & (Sr <= cfg.mcra.delta_s)
    Rvv_cand = rank1_update(state.Rvv, Z, cfg.alpha_v)
    eye = jnp.eye(Z.shape[-1], dtype=Z.dtype)
    load = cfg.diag
    if cfg.rel_diag:
        M = Z.shape[-1]
        tr = jnp.einsum("...fmm->...f", Rvv_cand.real) / M
        load = cfg.diag + cfg.rel_diag * tr[..., None, None].astype(Z.dtype)
    a = steer.astype(Z.dtype)
    u_cand = ldl_solve(Rvv_cand + load * eye, jnp.broadcast_to(a, Z.shape))
    gate = update[..., None, None]
    Rvv = jnp.where(gate, Rvv_cand, state.Rvv)
    u = jnp.where(update[..., None], u_cand, state.u)

    # w = u / (a^H u); Yf = w^H Z = (u^H Z) / conj(a^H u)
    # multiply-reduce, not einsum: a tiny-M batched contraction becomes
    # per-bin dot_generals (see stats.linalg.matvec)
    den = jnp.sum(jnp.conj(a) * u, axis=-1)
    Yf = jnp.sum(jnp.conj(u) * Z, axis=-1) / jnp.conj(den)
    return MvdrState(Ryy=Ryy, Rvv=Rvv, u=u, mcra=mcra_state), Yf


def mvdr_scan(cfg: MvdrConfig, steer: jnp.ndarray, state: MvdrState, X: jnp.ndarray):
    """Scan the MVDR step over the frame axis.

    X: [T, ..., F, M] time-major spectrogram.
    Returns (final_state, Y [T, ..., F]).
    """
    return jax.lax.scan(lambda s, z: mvdr_step(cfg, steer, s, z), state, X)


def offline_mvdr_weights(
    X: jnp.ndarray, steer: jnp.ndarray, n_est_frames: int = 200, alpha: float = 0.9, diag: float = 1e-6
) -> jnp.ndarray:
    """Offline MVDR: recursive Rvv over the first ``n_est_frames`` frames,
    then fixed weights (AdaptiveMVDR2 / AdaptiveMVDR semantics,
    adaptivebeamformer.py:130-230, Rvv seeded with ones).

    X: [..., T, F, M] spectrogram; steer: [F, M].  Returns w [..., F, M].
    """
    M = X.shape[-1]
    ones = jnp.ones((*X.shape[:-3], X.shape[-2], M, M), dtype=X.dtype)

    def body(R, z):
        return alpha * R + (1.0 - alpha) * (z[..., :, None] * jnp.conj(z)[..., None, :]), None

    Rvv, _ = jax.lax.scan(body, ones, jnp.moveaxis(X[..., :n_est_frames, :, :], -3, 0))
    eye = jnp.eye(M, dtype=X.dtype)
    from distantspeech_tpu.stats.linalg import gauss_jordan_inv

    return mvdr_weights(steer.astype(X.dtype), gauss_jordan_inv(Rvv + diag * eye))


def adaptive_mvdr2_process(
    x: jnp.ndarray,
    steer: jnp.ndarray,
    frame_len: int = 256,
    hop: int = 128,
    n_est_frames: int = 200,
    alpha: float = 0.9,
    diag: float = 1e-6,
) -> jnp.ndarray:
    """Offline MVDR with frame-tracking weights during estimation
    (AdaptiveMVDR2 semantics, adaptivebeamformer.py:130-180, exactly):

    Rvv starts at ones; for the first ``n_est_frames`` frames each frame's
    rank-1 update is folded in and the MVDR weights recomputed *before*
    being applied to that same frame; afterwards the weights freeze.  The
    reconstruction is the reference's window^2-normalised weighted
    overlap-add (net scale irfft(sum_m conj(H) Z), :174-180).

    Like the reference, Rvv is estimated from the raw mixture with no VAD:
    the estimation window must be (near) noise-only, or a coherent target
    inside it is absorbed into Rvv and self-cancelled (MPDR behaviour —
    measured 300x *worse* than the input on a target-during-estimation
    scene, for the reference and this port alike).  Use ``mvdr_process``
    for the MCRA-gated online variant.

    x: [M, S] time signal; steer: [F, M].  Returns y [out_len].
    """
    from distantspeech_tpu.stats.linalg import gauss_jordan_inv

    M, S = x.shape
    overlap = frame_len - hop
    T = int(round((S - overlap) // hop))
    # periodic Hann, windows.hann(frameLen, sym=False) (adaptivebeamformer.py:140)
    window = jnp.asarray(0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(frame_len) / frame_len), dtype=x.dtype)

    starts = jnp.arange(T) * hop
    frames = jax.vmap(lambda s: jax.lax.dynamic_slice(x, (0, s), (M, frame_len)))(starts)
    Z = jnp.fft.rfft(frames * window, axis=-1)  # [T, M, F]
    Z = jnp.swapaxes(Z, -1, -2)  # [T, F, M]

    F = Z.shape[-2]
    eye = jnp.eye(M, dtype=Z.dtype)
    a = jnp.broadcast_to(steer.astype(Z.dtype), (F, M))
    n_est = min(int(n_est_frames), T)

    # frame-tracking weights only exist inside the estimation window, so the
    # scan (with its per-frame [F, M, M] inverse) covers just those frames;
    # the remaining ~T - n_est frames apply the frozen weights in one einsum
    def body(carry, z):
        Rvv, _ = carry
        Rvv = alpha * Rvv + (1.0 - alpha) * (z[..., :, None] * jnp.conj(z)[..., None, :])
        H = mvdr_weights(a, gauss_jordan_inv(Rvv + diag * eye))
        Yf = jnp.sum(jnp.conj(H) * z, axis=-1)
        return (Rvv, H), Yf

    Rvv0 = jnp.ones((F, M, M), dtype=Z.dtype)
    H0 = mvdr_weights(a, gauss_jordan_inv(Rvv0 + diag * eye))  # the reference's
    # pre-loop weights (adaptivebeamformer.py:152-154); applied only if n_est == 0
    (_, H_fin), Y_est = jax.lax.scan(body, (Rvv0, H0), Z[:n_est])
    Y_rest = jnp.einsum("fm,tfm->tf", jnp.conj(H_fin), Z[n_est:], precision="highest")
    Y = jnp.concatenate([Y_est, Y_rest], axis=0)

    # window^2-normalised OLA (adaptivebeamformer.py:175-180); the reference's
    # win_scale * window.sum() on the synthesis frame cancels to 1
    Cf = jnp.fft.irfft(Y, n=frame_len, axis=-1) * window  # [T, frame_len]
    out_len = frame_len + (T - 1) * hop
    idx = (starts[:, None] + jnp.arange(frame_len)[None, :]).reshape(-1)
    yout = jnp.zeros(out_len, dtype=x.dtype).at[idx].add(Cf.reshape(-1))
    norm = jnp.zeros(out_len, dtype=x.dtype).at[idx].add(
        jnp.broadcast_to(window**2, (T, frame_len)).reshape(-1)
    )
    return yout / jnp.where(norm > 1e-10, norm, 1.0)


def mvdr_process(
    x: jnp.ndarray,
    geometry: ArrayGeometry,
    look_angle_deg=(0.0, 0.0),
    cfg: MvdrConfig = MvdrConfig(),
) -> jnp.ndarray:
    """Offline adaptive MVDR of a time-domain batch.

    x: [..., C, S] multichannel time signal.
    Returns [..., S] enhanced signal.
    """
    angle_rad = np.asarray(look_angle_deg, dtype=np.float64) / 180.0 * np.pi
    steer = jnp.asarray(steering_vector(geometry, angle_rad, cfg.stft.n_fft))

    X = analysis(x, cfg.stft)  # [..., C, T, F]
    Xt = jnp.moveaxis(jnp.moveaxis(X, -3, -1), -3, 0)  # [T, ..., F, C]
    state = mvdr_init(cfg, geometry.n_mics, batch_shape=Xt.shape[1:-2], cdtype=Xt.dtype)
    _, Y = mvdr_scan(cfg, steer, state, Xt)  # [T, ..., F]
    Y = jnp.moveaxis(Y, 0, -2)  # [..., T, F]
    return synthesis(Y, cfg.stft)
