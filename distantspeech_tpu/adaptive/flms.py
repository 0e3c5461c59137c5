"""Fast frequency-domain block LMS (overlap-save), multichannel.

Oracle: FastFreqLms (/root/reference/DistantSpeech/adaptivefilter/
FastFreqLms.py:48-260) — the workhorse under the GSC blocking matrices,
interference cancellers, AEC and the KWS cleaner.  One step processes one
hop of samples; everything is batched over channels / leading axes and the
FFT axis sits last (contiguous minor dimension).

Semantics preserved exactly, including:

- power normalisation P with the **stored** clamp ``P = max(P, 1e-4)``
  applied at gradient time (FastFreqLms.py:189 mutates state);
- gradient constraint zeroing the last ``hop`` samples of the time-domain
  gradient (:194-200);
- optional non-causal mode delaying d by filter_len/2 (:87-89, :172-174);
- optional two-path foreground/background logic (:105-113, :166-180): the
  *foreground* output (blended on transfer) is what the caller receives and
  what drives the weight gradient;
- ``fir_truncate`` zeroing the first/last taps of w and re-deriving W
  (:249-254).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp

from distantspeech_tpu.ops.dft import irdft, rdft
import numpy as np

from distantspeech_tpu.ops.delay import delay_samples


@dataclasses.dataclass(frozen=True)
class FlmsConfig:
    filter_len: int = 128
    hop_len: Optional[int] = None
    win_len: Optional[int] = None
    n_channels: int = 1
    mu: float = 0.01
    alpha: float = 0.9  # power-estimate pole
    constrain: bool = True
    non_causal: bool = False
    two_path: bool = False

    @property
    def hop(self) -> int:
        return self.filter_len if self.hop_len is None else self.hop_len

    @property
    def win(self) -> int:
        return 2 * self.filter_len if self.win_len is None else self.win_len

    @property
    def n_fft(self) -> int:
        # smallest power of two > hop + filter_len - 1 (FastFreqLms.py:74-75)
        min_win = self.hop + self.filter_len - 1
        return 2 ** (int(np.log2(min_win)) + 1)

    @property
    def half_bin(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def overlap(self) -> int:
        return self.win - self.hop

    def window(self) -> np.ndarray:
        n = np.arange(self.n_fft)
        return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / self.n_fft)


class FlmsState(NamedTuple):
    buf: jnp.ndarray  # input buffer [..., C, win]
    W: jnp.ndarray  # filter spectrum [..., C, Fb] complex
    P: jnp.ndarray  # power estimate  [..., Fb]
    foreground: jnp.ndarray  # two-path foreground spectrum [..., C, Fb]
    d_delay: jnp.ndarray  # non-causal delay carry [..., D]


def flms_init(cfg: FlmsConfig, batch_shape=(), dtype=jnp.float32) -> FlmsState:
    C = cfg.n_channels
    cdtype = jnp.zeros(0, dtype=dtype).astype(jnp.result_type(dtype, jnp.complex64)).dtype
    W = jnp.zeros((*batch_shape, C, cfg.half_bin), dtype=cdtype)
    D = cfg.filter_len // 2 if cfg.non_causal else 0
    return FlmsState(
        buf=jnp.zeros((*batch_shape, C, cfg.win), dtype=dtype),
        W=W,
        P=jnp.zeros((*batch_shape, cfg.half_bin), dtype=dtype),
        foreground=W,
        d_delay=jnp.zeros((*batch_shape, D), dtype=dtype),
    )


def flms_set_weights(cfg: FlmsConfig, state: FlmsState, w: jnp.ndarray) -> FlmsState:
    """Replace the (single-channel) filter with time-domain taps w [..., L]
    (FastFreqLms.set_weights, :115-120)."""
    W = rdft(w, n=cfg.n_fft, axis=-1)
    return state._replace(W=W[..., None, :] if W.ndim == state.W.ndim - 1 else W)


def flms_step(
    cfg: FlmsConfig,
    state: FlmsState,
    x: jnp.ndarray,
    d: jnp.ndarray,
    update=True,
    p=1.0,
    fir_truncate: Optional[int] = None,
) -> Tuple[FlmsState, Tuple[jnp.ndarray, jnp.ndarray]]:
    """One hop of overlap-save FLMS.

    x: [..., C, hop] input block; d: [..., hop] desired block.
    ``update`` may be a bool or a traced scalar/array (weight freeze gate);
    ``p`` is the stepsize gate (scalar or per-bin [Fb]).
    Returns (new_state, (e [..., hop], w [..., C, filter_len])).
    """
    hop, L, n_fft = cfg.hop, cfg.filter_len, cfg.n_fft

    buf = jnp.concatenate([state.buf[..., hop:], x], axis=-1)  # [..., C, win]
    X = rdft(buf, n=n_fft, axis=-1)  # [..., C, Fb]
    P = cfg.alpha * state.P + (1.0 - cfg.alpha) * jnp.sum(jnp.real(X * jnp.conj(X)), axis=-2)

    y = irdft(jnp.sum(X * state.W, axis=-2), n=n_fft, axis=-1)[..., -hop:]

    d_delay = state.d_delay
    if cfg.non_causal:
        d_delay, d = delay_samples(state.d_delay, d)

    e = d - y
    foreground = state.foreground
    if cfg.two_path:
        if hop != L or cfg.overlap != L:
            raise ValueError("two_path requires default hop == filter_len layout")
        y_f = jnp.sum(irdft(X * state.foreground, n=n_fft, axis=-1)[..., -L:], axis=-2)
        e_f = d - y_f
        # transfer logic (FastFreqLms.py:105-113): background 3 dB better?
        ratio = jnp.sum(jnp.abs(e_f), axis=-1) / (jnp.sum(jnp.abs(e), axis=-1) + 1e-6)
        transfer = 10.0 * jnp.log10(ratio + 1e-6) > 3.0
        win = jnp.asarray(cfg.window(), dtype=y.dtype)
        y_blend = win[L:] * y_f + win[:L] * y
        y_out = jnp.where(transfer[..., None], y_blend, y_f)
        foreground = jnp.where(transfer[..., None, None], state.W, state.foreground)
        e = d - y_out

    # gradient: E = rfft([zeros(overlap); e]) (compute_freq_xcorr, :183-192)
    pad = [(0, 0)] * (e.ndim - 1) + [(cfg.overlap, 0)]
    E = rdft(jnp.pad(e, pad), n=n_fft, axis=-1)  # [..., Fb]
    P = jnp.maximum(P, 1e-4)  # stored clamp (:189)
    grad = jnp.conj(X) * E[..., None, :] / P[..., None, :]

    if cfg.constrain:
        g1 = irdft(grad, n=n_fft, axis=-1)
        g1 = g1.at[..., -hop:].set(0.0)
        grad = rdft(g1, n=n_fft, axis=-1)

    gate = jnp.asarray(update, dtype=P.dtype)
    W = state.W + gate * p * 2.0 * cfg.mu * grad

    w = irdft(W, n=n_fft, axis=-1)[..., :L]
    if fir_truncate is not None:
        w_shift = w.at[..., :fir_truncate].set(0.0).at[..., -fir_truncate:].set(0.0)
        W = rdft(w_shift, n=n_fft, axis=-1)

    return FlmsState(buf=buf, W=W, P=P, foreground=foreground, d_delay=d_delay), (e, w)
