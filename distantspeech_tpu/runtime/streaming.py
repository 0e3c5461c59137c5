"""Realtime-style streaming driver: host ring buffer feeding a jitted step.

Capability parity with realtime_processing
(/root/reference/DistantSpeech/realtime/realtime_processing.py:9-137): a
capture source delivers fixed-size chunks; each chunk runs through one
jitted streaming step carrying the pipeline state; a latency monitor flags
overflow when a chunk takes longer than its real-time budget
(realtime_processing.py:126-127).  The audio-device layer is pluggable —
any iterator of [C, chunk] arrays works; a PyAudio source is provided when
the package is installed (it is not in this image).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Iterable, Iterator, Optional, Tuple

import numpy as np
import jax


class StreamingProcessor:
    """Drive a ``step(state, chunk) -> (state, out)`` function chunk by chunk.

    Parameters
    ----------
    step : callable
        Pure streaming step; jitted on first use.
    init_state : pytree
        Initial carry (from the pipeline's ``*_init``).
    chunk_size : int
        Samples per chunk per channel (the reference uses 1024).
    fs : int
        Sample rate, for the real-time overflow check.
    """

    def __init__(self, step: Callable, init_state: Any, chunk_size: int = 1024, fs: int = 16000):
        self.step = jax.jit(step)
        self.state = init_state
        self.chunk_size = chunk_size
        self.fs = fs
        self.overflows = 0
        self.chunks = 0
        self.latencies: list = []  # seconds per chunk, incl. host<->device

    def process_chunk(self, chunk: np.ndarray) -> np.ndarray:
        budget = self.chunk_size / self.fs
        t0 = time.perf_counter()
        self.state, out = self.step(self.state, chunk)
        out = np.asarray(out)
        dt = time.perf_counter() - t0
        self.latencies.append(dt)
        if dt > budget:
            self.overflows += 1  # "time_cost overflow" (realtime_processing.py:126-127)
        self.chunks += 1
        return out

    def latency_report(self, skip_warmup: int = 1) -> dict:
        """Machine-readable chunk-latency summary (the reference's overflow
        contract, realtime_processing.py:126-127, as an artifact).

        ``skip_warmup`` chunks (jit compile) are excluded from the
        percentile stats AND from ``overflows`` — a compile is not a
        latency miss, and a consumer gating on ``overflows == 0`` should
        see the steady-state realtime contract.  The raw count including
        warmup is reported as ``overflows_incl_warmup``; the actual
        exclusion is capped so at least one chunk remains, and the report
        records it as ``warmup_excluded``.
        """
        skipped = min(skip_warmup, max(len(self.latencies) - 1, 0))
        lat = np.asarray(self.latencies[skipped:])
        budget = self.chunk_size / self.fs
        ms = lambda v: round(float(v) * 1e3, 4)
        dev = jax.devices()[0]
        return {
            "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())},
            "chunks": self.chunks,
            "overflows": int(np.sum(lat > budget)),
            "overflows_incl_warmup": self.overflows,
            "chunk_size": self.chunk_size,
            "fs": self.fs,
            "budget_ms": ms(budget),
            "warmup_excluded": skipped,
            "p50_ms": ms(np.percentile(lat, 50)) if lat.size else None,
            "p95_ms": ms(np.percentile(lat, 95)) if lat.size else None,
            "max_ms": ms(lat.max()) if lat.size else None,
            "mean_ms": ms(lat.mean()) if lat.size else None,
            "realtime_factor": round(budget / float(lat.mean()), 2) if lat.size else None,
        }

    def run(self, source: Iterable[np.ndarray], sink: Optional[Callable[[np.ndarray], None]] = None):
        """Consume a chunk iterator; returns concatenated output if no sink."""
        outs = []
        for chunk in source:
            out = self.process_chunk(chunk)
            if sink is not None:
                sink(out)
            else:
                outs.append(out)
        if outs:
            return np.concatenate(outs, axis=-1)
        return None


def make_enhance_stream(
    geometry, look_angle_deg=(90.0, 0.0), cfg=None, chunk_size: int = 1024, fs: int = 16000
) -> "StreamingProcessor":
    """Streaming flagship pipeline (MVDR + OM-LSA) as a StreamingProcessor.

    The realtime app loop of the reference (realtime_processing.py:70-136)
    with the per-chunk enhancement step jitted: chunk [M, chunk_size] in,
    [chunk_size] enhanced samples out (hop-aligned; cfg.stft.hop must
    divide chunk_size).  The carry is the STFT tails + covariances + MCRA
    minima.
    """
    import jax.numpy as jnp

    from distantspeech_tpu.array.steering import steering_vector
    from distantspeech_tpu.beamform.enhance import EnhanceConfig, enhance_init, enhance_step
    from distantspeech_tpu.transform.stft import istft_stream, stft_stream

    if cfg is None:
        cfg = EnhanceConfig()
    if chunk_size % cfg.stft.hop != 0:
        raise ValueError(f"chunk_size {chunk_size} must be a multiple of hop {cfg.stft.hop}")
    M = geometry.n_mics
    angle_rad = np.asarray(look_angle_deg, dtype=np.float64) / 180.0 * np.pi
    steer = np.asarray(steering_vector(geometry, angle_rad, cfg.stft.n_fft), dtype=np.complex64)

    def step(state, x_chunk):
        cin, cout, enh = state
        cin, Z = stft_stream(cin, x_chunk, cfg.stft)  # [M, J, F]
        Zt = jnp.moveaxis(Z, -2, 0).swapaxes(-1, -2)  # [J, F, M]
        enh, Y = jax.lax.scan(lambda s, z: enhance_step(cfg, jnp.asarray(steer), s, z), enh, Zt)
        cout, y = istft_stream(cout, jnp.moveaxis(Y, 0, -2), cfg.stft)
        return (cin, cout, enh), y

    init = jax.jit(lambda: (
        jnp.zeros((M, cfg.stft.overlap), jnp.float32),
        jnp.zeros(cfg.stft.overlap, jnp.float32),
        enhance_init(cfg, M),
    ))()
    return StreamingProcessor(step, init, chunk_size=chunk_size, fs=fs)


def make_gsc_stream(
    geometry, look_angle_deg=(90.0, 0.0), cfg=None, chunk_size: int = 1024, fs: int = 16000
) -> "StreamingProcessor":
    """Streaming frequency-domain GSC (reference example/streaming_gsc.py:
    realtime_processing drives GSC.process per chunk).  Defaults to the
    production-robust configuration (normalised AIC + relative SPP diagonal
    loading) — pass an explicit ``GscConfig`` for the reference-exact one.
    Chunk [M, chunk_size] in, [chunk_size] out."""
    import jax.numpy as jnp

    from distantspeech_tpu.beamform.gsc import GscConfig, gsc_init, gsc_step, gsc_steering
    from distantspeech_tpu.transform.stft import istft_stream, stft_stream

    if cfg is None:
        cfg = GscConfig(n_mics=geometry.n_mics, normalize_aic=True, spp_rel_diag=1e-5)
    if chunk_size % cfg.stft.hop != 0:
        raise ValueError(f"chunk_size {chunk_size} must be a multiple of hop {cfg.stft.hop}")
    M = cfg.n_mics
    angle_rad = np.asarray(look_angle_deg, dtype=np.float64) / 180.0 * np.pi
    a = np.asarray(gsc_steering(cfg, geometry, angle_rad), dtype=np.complex64)

    def step(state, x_chunk):
        cin, cout, gs = state
        cin, Z = stft_stream(cin, x_chunk, cfg.stft)  # [M, J, F]
        Zt = jnp.moveaxis(Z, -2, 0).swapaxes(-1, -2)  # [J, F, M]
        gs, Y = jax.lax.scan(lambda s, z: gsc_step(cfg, jnp.asarray(a).astype(z.dtype), s, z), gs, Zt)
        cout, y = istft_stream(cout, jnp.moveaxis(Y, 0, -2), cfg.stft)
        return (cin, cout, gs), y

    init = jax.jit(lambda: (
        jnp.zeros((M, cfg.stft.overlap), jnp.float32),
        jnp.zeros(cfg.stft.overlap, jnp.float32),
        gsc_init(cfg),
    ))()
    return StreamingProcessor(step, init, chunk_size=chunk_size, fs=fs)


def make_fdgsc_stream(
    geometry, look_angle_deg=(90.0, 0.0), cfg=None, chunk_size: int = 1024, fs: int = 16000,
    dc_notch_input: bool = True,
) -> "StreamingProcessor":
    """Streaming overlap-save robust GSC (reference example/streaming_fdgsc.py).

    The offline driver's whole-signal preprocessing (DC notch IIR + time
    alignment FIR) becomes two more carries — the block step itself is the
    same ``fdgsc_step``, so streaming output equals offline exactly."""
    import jax.numpy as jnp

    from distantspeech_tpu.adaptive.feature import dc_notch, dc_notch_init
    from distantspeech_tpu.array.alignment import time_alignment_filters
    from distantspeech_tpu.beamform.fdgsc import FdGscConfig, fdgsc_init, fdgsc_step
    from distantspeech_tpu.ops.fir import fir_filter_block

    if cfg is None:
        cfg = FdGscConfig(n_mics=geometry.n_mics)
    L = cfg.frame_len
    if chunk_size % L != 0:
        raise ValueError(f"chunk_size {chunk_size} must be a multiple of frame_len {L}")
    M = cfg.n_mics
    angle_rad = np.asarray(look_angle_deg, dtype=np.float64) / 180.0 * np.pi
    coeffs = np.asarray(time_alignment_filters(geometry, angle_rad), dtype=np.float32)
    J = chunk_size // L

    def step(state, x_chunk):
        dc, cache, ps = state
        xn = x_chunk
        if dc_notch_input:
            dc, xn = dc_notch(dc, x_chunk, radius=0.98)
        cache, aligned = fir_filter_block(cache, xn, jnp.asarray(coeffs))
        xb = jnp.moveaxis(xn.reshape(M, J, L), 1, 0)  # [J, M, L]
        ab = jnp.moveaxis(aligned.reshape(M, J, L), 1, 0)
        ps, (out, _, _) = jax.lax.scan(lambda s, blk: fdgsc_step(cfg, s, blk[0], blk[1]), ps, (xb, ab))
        return (dc, cache, ps), out.reshape(-1)

    init = jax.jit(lambda: (
        dc_notch_init((M,)),
        jnp.zeros((M, coeffs.shape[-1] - 1), jnp.float32),
        fdgsc_init(cfg),
    ))()
    return StreamingProcessor(step, init, chunk_size=chunk_size, fs=fs)


def make_subband_gsc_stream(
    geometry, look_angle_deg=(90.0, 0.0), cfg=None, chunk_size: int = 1024, fs: int = 16000
) -> "StreamingProcessor":
    """Streaming SubbandGSC (reference SubbandGSC driven by the realtime
    loop): DC notch + time alignment carries feeding ``subband_gsc_step``."""
    import jax.numpy as jnp

    from distantspeech_tpu.adaptive.feature import dc_notch, dc_notch_init
    from distantspeech_tpu.array.alignment import time_alignment_filters
    from distantspeech_tpu.beamform.subband_gsc import (
        SubbandGscConfig, subband_gsc_init, subband_gsc_step,
    )
    from distantspeech_tpu.ops.fir import fir_filter_block

    if cfg is None:
        cfg = SubbandGscConfig(n_mics=geometry.n_mics)
    L = cfg.frame_len
    if chunk_size % L != 0:
        raise ValueError(f"chunk_size {chunk_size} must be a multiple of frame_len {L}")
    M = cfg.n_mics
    angle_rad = np.asarray(look_angle_deg, dtype=np.float64) / 180.0 * np.pi
    coeffs = np.asarray(time_alignment_filters(geometry, angle_rad), dtype=np.float32)
    Fn = np.asarray(cfg.spp.mccdr.fn_pair(), dtype=np.float32)
    J = chunk_size // L

    def step(state, x_chunk):
        dc, cache, ps = state
        dc, xn = dc_notch(dc, x_chunk, radius=0.98)
        cache, aligned = fir_filter_block(cache, xn, jnp.asarray(coeffs))
        ab = jnp.moveaxis(aligned.reshape(M, J, L), 1, 0)  # [J, M, L]
        ps, (out, _, _) = jax.lax.scan(
            lambda s, blk: subband_gsc_step(cfg, jnp.asarray(Fn), s, blk), ps, ab
        )
        return (dc, cache, ps), out.reshape(-1)

    init = jax.jit(lambda: (
        dc_notch_init((M,)),
        jnp.zeros((M, coeffs.shape[-1] - 1), jnp.float32),
        subband_gsc_init(cfg),
    ))()
    return StreamingProcessor(step, init, chunk_size=chunk_size, fs=fs)


def make_wpe_stream(
    geometry=None, look_angle_deg=None, cfg=None, chunk_size: int = 1024, fs: int = 16000,
    n_channels: int = None,
) -> "StreamingProcessor":
    """Streaming adaptive WPE dereverberation (the reference Wpe.update is
    already frame-recursive, awpe.py:129-192): subband analysis carry, a
    ``delay``-frame regressor delay line, the RLS state, and the synthesis
    time-delay line.  Geometry/angle are accepted (and ignored) for registry
    uniformity.  Chunk [C, chunk_size] in, [chunk_size] dereverberated
    reference channel out."""
    import jax.numpy as jnp

    from distantspeech_tpu.derev.wpe import WpeConfig, wpe_init, wpe_step
    from distantspeech_tpu.transform.subband import (
        subband_analysis_stream, subband_synthesis_init, subband_synthesis_step,
    )

    if cfg is None:
        C = n_channels or (geometry.n_mics if geometry is not None else 2)
        cfg = WpeConfig(n_channels=C)
    C = cfg.n_channels
    sb = cfg.subband
    if chunk_size % sb.hop != 0:
        raise ValueError(f"chunk_size {chunk_size} must be a multiple of hop {sb.hop}")
    h = np.asarray(sb.prototypes()[0], dtype=np.float32)
    g = np.asarray(sb.prototypes()[1], dtype=np.float32)
    J = chunk_size // sb.hop

    def step(state, x_chunk):
        cin, dbuf, ws, tdl = state
        cin, Y = subband_analysis_stream(cin, x_chunk, sb, jnp.asarray(h))  # [C, J, F]
        Dt = jnp.moveaxis(Y, 0, -1)  # [J, F, C]
        ext = jnp.concatenate([dbuf, Dt], axis=0)  # [delay + J, F, C]
        delayed, dbuf = ext[:J], ext[J:]
        ws, e = jax.lax.scan(lambda s, dd: wpe_step(cfg, s, dd[0], dd[1]), ws, (Dt, delayed))
        tdl, y = jax.lax.scan(lambda c, yf: subband_synthesis_step(c, yf, sb, jnp.asarray(g)), tdl, e[..., 0])
        return (cin, dbuf, ws, tdl), y.reshape(-1)

    init = jax.jit(lambda: (
        jnp.zeros((C, sb.overlap), jnp.float32),
        jnp.zeros((cfg.delay, sb.half_bin, C), jnp.complex64),
        wpe_init(cfg),
        subband_synthesis_init((), sb),
    ))()
    return StreamingProcessor(step, init, chunk_size=chunk_size, fs=fs)


def make_tdgsc_stream(
    geometry, look_angle_deg=(197.0, 0.0), cfg=None, chunk_size: int = 1024, fs: int = 16000
) -> "StreamingProcessor":
    """Streaming time-domain GSC (reference TDGSC driven by the realtime
    loop, TDGSC.py:110-172): DC notch + alignment FIR carries feeding
    ``tdgsc_step``.  Chunk [M, chunk_size] in, [chunk_size] out."""
    import jax.numpy as jnp

    from distantspeech_tpu.adaptive.feature import dc_notch, dc_notch_init
    from distantspeech_tpu.array.alignment import time_alignment_filters
    from distantspeech_tpu.beamform.tdgsc import TdGscConfig, tdgsc_init, tdgsc_step
    from distantspeech_tpu.ops.fir import fir_filter_block

    if cfg is None:
        cfg = TdGscConfig(n_mics=geometry.n_mics)
    L = cfg.frame_len
    if chunk_size % L != 0:
        raise ValueError(f"chunk_size {chunk_size} must be a multiple of frame_len {L}")
    M = cfg.n_mics
    angle_rad = np.asarray(look_angle_deg, dtype=np.float64) / 180.0 * np.pi
    coeffs = np.asarray(time_alignment_filters(geometry, angle_rad), dtype=np.float32)
    J = chunk_size // L

    def step(state, x_chunk):
        dc, cache, ts = state
        dc, xn = dc_notch(dc, x_chunk, radius=0.98)
        cache, aligned = fir_filter_block(cache, xn, jnp.asarray(coeffs))
        fbf = jnp.mean(aligned, axis=-2)
        bm = aligned[:-1] - aligned[1:]
        fb = fbf.reshape(J, L)
        bb = jnp.moveaxis(bm.reshape(M - 1, J, L), 1, 0)  # [J, M-1, L]
        ts, (out, _) = jax.lax.scan(lambda s, blk: tdgsc_step(cfg, s, blk[0], blk[1]), ts, (fb, bb))
        return (dc, cache, ts), out.reshape(-1)

    init = jax.jit(lambda: (
        dc_notch_init((M,)),
        jnp.zeros((M, coeffs.shape[-1] - 1), jnp.float32),
        tdgsc_init(cfg),
    ))()
    return StreamingProcessor(step, init, chunk_size=chunk_size, fs=fs)


def make_full_stack_stream(
    geometry, look_angle_deg=(197.0, 0.0), cfg=None, chunk_size: int = 1024, fs: int = 16000
) -> "StreamingProcessor":
    """Streaming FULL stack — BASELINE config 5: AEC (MDF two-path) per mic
    + dual-mic KWS tap + TDGSC + OMLSA postfilter, one carry, one jitted
    chunk step (the reference's realtime loop drives any method the same
    way, realtime_processing.py:78-84).

    Chunk layout [M + 1, chunk_size]: rows 0..M-1 are the microphones, the
    LAST row is the far-end playback reference (the echo path input the
    offline driver takes as a separate argument).  Output [chunk_size] is
    the enhanced signal; the KWS-cleaned tap rides along in the carry's
    last output and can be recovered via a custom sink if needed."""
    import jax.numpy as jnp

    from distantspeech_tpu.array.alignment import time_alignment_filters
    from distantspeech_tpu.runtime.full_stack import (
        FullStackConfig, full_stack_init, full_stack_step,
    )

    if cfg is None:
        cfg = FullStackConfig(n_mics=geometry.n_mics)
    L = cfg.frame_len
    if chunk_size % L != 0:
        raise ValueError(f"chunk_size {chunk_size} must be a multiple of frame_len {L}")
    M = cfg.n_mics
    angle_rad = np.asarray(look_angle_deg, dtype=np.float64) / 180.0 * np.pi
    coeffs_np = np.asarray(time_alignment_filters(geometry, angle_rad), dtype=np.float32)
    J = chunk_size // L

    from distantspeech_tpu.ops.fir import fir_block_taps

    # Toeplitz taps precomputed outside the per-chunk scan (fir_block_taps)
    taps = fir_block_taps(jnp.asarray(coeffs_np), L)

    def step(state, chunk):
        x, far = chunk[:-1], chunk[-1]
        xb = jnp.moveaxis(x.reshape(M, J, L), 1, 0)  # [J, M, L]
        fb = far.reshape(J, L)
        state, (out, _, _) = jax.lax.scan(
            lambda s, blk: full_stack_step(cfg, taps, s, blk[0], blk[1]),
            state, (xb, fb),
        )
        return state, out.reshape(-1)

    init = jax.jit(lambda: full_stack_init(cfg, coeffs_np))()
    return StreamingProcessor(step, init, chunk_size=chunk_size, fs=fs)


#: pipeline-name -> stream factory; the CLI's --stream resolves here (the
#: reference's realtime_processing drives *any* EnhancementMethod,
#: realtime/realtime_processing.py:78-84 — this registry is that contract).
STREAM_FACTORIES = {
    "enhance": make_enhance_stream,
    "gsc": make_gsc_stream,
    "fdgsc": make_fdgsc_stream,
    "subband_gsc": make_subband_gsc_stream,
    "wpe": make_wpe_stream,
    "tdgsc": make_tdgsc_stream,
    "full_stack": make_full_stack_stream,
}


def wav_chunks(x: np.ndarray, chunk_size: int) -> Iterator[np.ndarray]:
    """Slice [C, S] audio into [C, chunk_size] chunks (tail dropped)."""
    for i in range(0, x.shape[-1] - chunk_size + 1, chunk_size):
        yield x[..., i : i + chunk_size]


def pyaudio_chunks(chunk_size: int = 1024, fs: int = 16000, channels: int = 6, pick=slice(1, 5)):
    """Live capture source (requires pyaudio; mirrors realtime_processing.py:86-123)."""
    import pyaudio  # noqa: optional dependency, absent in this image

    pa = pyaudio.PyAudio()
    stream = pa.open(format=pyaudio.paInt16, channels=channels, rate=fs, input=True,
                     frames_per_buffer=chunk_size)
    try:
        while True:
            raw = stream.read(chunk_size)
            data = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
            yield data.reshape(chunk_size, channels).T[pick]
    finally:
        stream.stop_stream()
        stream.close()
        pa.terminate()
