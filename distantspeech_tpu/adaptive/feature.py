"""Pre/de-emphasis and speex-style DC notch as parallel linear recurrences.

Oracle: Emphasis / FilterDcNotch16
(/root/reference/DistantSpeech/adaptivefilter/feature.py:7-63).  The
reference runs these sample-serially; here the FIR pre-emphasis is a shift
(no recurrence at all), the de-emphasis is a first-order IIR evaluated in
log depth via ``ops.iir.first_order_recurrence``, and the biquad-like DC
notch is a 2-state affine recurrence via ``ops.iir.affine_recurrence``.
All functions are blockwise streaming: they take and return an explicit
carry so chunked processing matches sample-serial output exactly.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

from distantspeech_tpu.ops.iir import constant_affine_blocked, first_order_recurrence


class EmphasisState(NamedTuple):
    memD: jnp.ndarray  # last input sample   [...]
    memE: jnp.ndarray  # last output sample  [...]


def emphasis_init(batch_shape=(), dtype=jnp.float32) -> EmphasisState:
    z = jnp.zeros(batch_shape, dtype=dtype)
    return EmphasisState(memD=z, memE=z)


def pre_emphasis(state: EmphasisState, x: jnp.ndarray, alpha: float = 0.98) -> Tuple[EmphasisState, jnp.ndarray]:
    """y[n] = x[n] - alpha x[n-1]  (feature.py:14-21).  x: [..., N]."""
    prev = jnp.concatenate([state.memD[..., None], x[..., :-1]], axis=-1)
    y = x - alpha * prev
    return state._replace(memD=x[..., -1]), y


def de_emphasis(state: EmphasisState, x: jnp.ndarray, alpha: float = 0.98) -> Tuple[EmphasisState, jnp.ndarray]:
    """y[n] = x[n] + alpha y[n-1]  (feature.py:23-30).  x: [..., N]."""
    y = first_order_recurrence(alpha, x, state.memE)
    return state._replace(memE=y[..., -1]), y


class DcNotchState(NamedTuple):
    mem: jnp.ndarray  # [..., 2]


def dc_notch_init(batch_shape=(), dtype=jnp.float32) -> DcNotchState:
    return DcNotchState(mem=jnp.zeros((*batch_shape, 2), dtype=dtype))


def dc_notch(state: DcNotchState, x: jnp.ndarray, radius: float = 0.9) -> Tuple[DcNotchState, jnp.ndarray]:
    """Speex DC-notch biquad (feature.py:37-54).

    Per sample (vin = x[n], vout = mem0 + vin):
        out[n] = radius * vout
        mem0'  = mem1 + 2 (-vin + radius vout)
        mem1'  = vin - den2 vout,   den2 = radius^2 + 0.7 (1-radius)^2

    i.e. mem' = A mem + b(vin) with constant A — an affine recurrence.
    x: [..., N] -> (new_state, out [..., N]).
    """
    r = radius
    den2 = r * r + 0.7 * (1.0 - r) * (1.0 - r)
    # mem0' = 2r*mem0 + mem1 + (2r - 2) vin ; mem1' = -den2*mem0 + (1 - den2) vin
    A = np.array([[2.0 * r, 1.0], [-den2, 0.0]])
    Bv = np.array([2.0 * r - 2.0, 1.0 - den2])

    # constant-matrix recurrence -> blocked state-space evaluation (two bulk
    # matmuls per 256-sample block; the sample-level log-depth scan sweeps
    # [.., N, k, k] through device memory log2(N) times, see ops.iir)
    mem_seq = constant_affine_blocked(A, Bv, x, state.mem)  # [..., N, 2] (post-sample states)
    # vout[n] = mem0[n-1] + x[n]
    mem0_prev = jnp.concatenate([state.mem[..., :1], mem_seq[..., :-1, 0]], axis=-1)
    out = r * (mem0_prev + x)
    return DcNotchState(mem=mem_seq[..., -1, :]), out
