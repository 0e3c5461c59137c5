"""Batched STFT / ISTFT with the reference's exact streaming semantics.

The reference Transform (/root/reference/DistantSpeech/transform/transform.py:407-496)
is a *streaming* sqrt-Hann analysis/synthesis pair with two quirks this module
reproduces bit-for-bit:

- synthesis does **not** divide by the window-sum-square envelope; instead it
  scales the overlap-added signal by ``hop / W0`` with ``W0 = sum(window**2)``
  (transform.py:479, commented-out normalisation at :375-384);
- chunked processing carries ``overlap = n_fft - hop`` samples of input
  (prepended before framing, transform.py:438-451) and of output tail
  (added into the next chunk's head, transform.py:476-478).

Design: all functions are pure and batched over arbitrary leading axes — the
frame loop of the reference becomes one rfft over a ``[..., T, n_fft]`` frame
tensor; the carries are explicit arguments/results so the same code path
serves offline (zero carry, whole utterance) and streaming (jitted per chunk).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from distantspeech_tpu.ops.framing import frame_signal, overlap_add


def sqrt_hann_window(n_fft: int) -> np.ndarray:
    """Square root of the periodic (DFT-even) Hann window, length n_fft.

    Matches scipy ``get_window('hann', n, fftbins=True)`` followed by sqrt
    (transform.py:418-419).
    """
    k = np.arange(n_fft)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * k / n_fft)
    return np.sqrt(hann)


@dataclasses.dataclass(frozen=True)
class StftConfig:
    """Static analysis/synthesis parameters (hashable: safe as a jit static)."""

    n_fft: int = 256
    hop: int = 128
    window_key: str = "sqrt_hann"

    @property
    def half_bin(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def overlap(self) -> int:
        return self.n_fft - self.hop

    @property
    def window(self) -> np.ndarray:
        if self.window_key != "sqrt_hann":
            raise ValueError(f"unknown window {self.window_key}")
        return sqrt_hann_window(self.n_fft)

    @property
    def w0(self) -> float:
        """Sum of squared window samples (transform.py:428)."""
        return float(np.sum(self.window**2))

    @property
    def synthesis_gain(self) -> float:
        """hop / W0 output scale of the reference synthesis (transform.py:479)."""
        return self.hop / self.w0


def _dft_matrices(cfg: StftConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Windowed forward rDFT as two real matrices: Y = f @ (C + iS).

    The window is folded in, so the whole analysis frame op is ONE real
    matmul pair (against cuFFT on the GPU: not measured yet).
    """
    n = np.arange(cfg.n_fft)[:, None]
    k = np.arange(cfg.half_bin)[None, :]
    ang = -2.0 * np.pi * n * k / cfg.n_fft
    w = cfg.window[:, None]
    return np.cos(ang) * w, np.sin(ang) * w


def _idft_matrices(cfg: StftConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Windowed inverse rDFT: frames = Yr @ A + Yi @ B (weights for the
    hermitian-symmetric bins, 1/N scale, and the synthesis window folded in).
    """
    k = np.arange(cfg.half_bin)[:, None]
    n = np.arange(cfg.n_fft)[None, :]
    ang = 2.0 * np.pi * k * n / cfg.n_fft
    scale = np.full((cfg.half_bin, 1), 2.0)
    scale[0] = 1.0
    if cfg.n_fft % 2 == 0:
        scale[-1] = 1.0
    w = cfg.window[None, :]
    A = np.cos(ang) * scale * w / cfg.n_fft
    B = -np.sin(ang) * scale * w / cfg.n_fft
    return A, B


def stft_frames(x: jnp.ndarray, cfg: StftConfig) -> jnp.ndarray:
    """Left-aligned STFT of ``x`` with no implicit padding.

    x: [..., samples] -> [..., T, half_bin] with T = 1 + (samples - n_fft)//hop.
    """
    C, S = _dft_matrices(cfg)
    F = cfg.half_bin
    # one matmul pass for both real and imaginary parts: the frames tensor
    # (the big operand) is read once.  precision='highest' keeps the f32
    # path at ~1e-7 relative error; a reduced-precision pass (bf16 or TF32)
    # would be ~1e-3 and break 1e-4 parity.  The sin columns at k=0 (and
    # k=F-1 for even n_fft) are dropped: their true DFT value is exactly 0
    # (sin(pi*n) is ~1e-16 rounding noise as computed), and the output
    # width stays a multiple of 128 (256 for n_fft=256).
    hi = F - 1 if cfg.n_fft % 2 == 0 else F
    CS = jnp.asarray(np.concatenate([C, S[:, 1:hi]], axis=1), dtype=x.dtype)
    if cfg.n_fft == 2 * cfg.hop:
        # 50% overlap: frame t = hop-blocks (t, t+1), both free reshapes —
        # two half-frame matmuls instead of materialising the 2x-sized
        # overlapping-frame tensor (a gather as large as the matmul).
        T = 1 + (x.shape[-1] - cfg.n_fft) // cfg.hop
        blocks = x[..., : (T + 1) * cfg.hop].reshape(*x.shape[:-1], T + 1, cfg.hop)
        Y = jnp.matmul(blocks[..., :-1, :], CS[: cfg.hop], precision="highest")
        Y = Y + jnp.matmul(blocks[..., 1:, :], CS[cfg.hop :], precision="highest")
    else:
        frames = frame_signal(x, cfg.n_fft, cfg.hop)
        Y = jnp.matmul(frames, CS, precision="highest")
    zero = jnp.zeros_like(Y[..., :1])
    tail = [zero] if hi == F - 1 else []
    return jax.lax.complex(Y[..., :F], jnp.concatenate([zero, Y[..., F:], *tail], axis=-1))


def istft_frames(Y: jnp.ndarray, cfg: StftConfig) -> jnp.ndarray:
    """Windowed inverse frames + overlap-add, **unnormalised**.

    Y: [..., T, half_bin] -> [..., n_fft + hop*(T-1)].
    """
    A, B = _idft_matrices(cfg)
    F = cfg.half_bin
    # the sin rows at k=0 (and k=F-1 for even n_fft) are structural zeros —
    # drop them and the matching imag inputs so the contraction dim is a
    # multiple of 128 (see stft_frames).
    hi = F - 1 if cfg.n_fft % 2 == 0 else F
    Yr = jnp.real(Y)
    AB = jnp.asarray(np.concatenate([A, B[1:hi]], axis=0), dtype=Yr.dtype)
    Yri = jnp.concatenate([Yr, jnp.imag(Y)[..., 1:hi]], axis=-1)
    frames = jnp.matmul(Yri, AB, precision="highest")
    return overlap_add(frames, cfg.hop)


def analysis(x: jnp.ndarray, cfg: StftConfig) -> jnp.ndarray:
    """Offline analysis of a whole signal, fresh-stream semantics.

    Equivalent to the reference ``Transform.stft`` called once on the full
    signal from its initial zero ``previous_input`` state: ``overlap`` zeros
    are prepended so x of length ``hop * T`` yields exactly T frames.

    x: [..., hop * T] -> [..., T, half_bin].
    """
    pad = [(0, 0)] * (x.ndim - 1) + [(cfg.overlap, 0)]
    return stft_frames(jnp.pad(x, pad), cfg)


def synthesis(Y: jnp.ndarray, cfg: StftConfig) -> jnp.ndarray:
    """Offline synthesis, fresh-stream semantics (inverse of ``analysis``).

    Matches ``Transform.istft`` from the zero ``previous_output`` state: the
    overlap-added signal is truncated to ``hop * T`` samples and scaled by
    ``hop / W0``.

    Y: [..., T, half_bin] -> [..., hop * T].
    """
    n_frames = Y.shape[-2]
    y = istft_frames(Y, cfg)
    return y[..., : cfg.hop * n_frames] * jnp.asarray(cfg.synthesis_gain, y.dtype)


def stft_stream(
    carry: jnp.ndarray, chunk: jnp.ndarray, cfg: StftConfig
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One streaming analysis step.

    carry: [..., overlap] previous input tail; chunk: [..., hop * J].
    Returns (new_carry, Y [..., J, half_bin]).
    """
    x = jnp.concatenate([carry, chunk], axis=-1)
    return x[..., -cfg.overlap :], stft_frames(x, cfg)


def istft_stream(
    carry: jnp.ndarray, Y: jnp.ndarray, cfg: StftConfig
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One streaming synthesis step.

    carry: [..., overlap] previous output tail; Y: [..., J, half_bin].
    Returns (new_carry, y [..., hop * J]).
    """
    y = istft_frames(Y, cfg)
    y = y.at[..., : cfg.overlap].add(carry)
    new_carry = y[..., -cfg.overlap :]
    out = y[..., : -cfg.overlap] * jnp.asarray(cfg.synthesis_gain, y.dtype)
    return new_carry, out


def stft_init_carry(batch_shape, cfg: StftConfig, dtype=jnp.float32) -> jnp.ndarray:
    return jnp.zeros((*batch_shape, cfg.overlap), dtype=dtype)


def magphase(D: jnp.ndarray, power: int = 1) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Split a complex spectrogram into magnitude**power and unit phase
    (Transform.magphase, transform.py:483-488)."""
    mag = jnp.abs(D) ** power
    phase = jnp.exp(1j * jnp.angle(D))
    return mag, phase
