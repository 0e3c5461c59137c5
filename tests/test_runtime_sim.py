"""Tests for runtime I/O, streaming driver, and room simulation."""

import os
import tempfile

import numpy as np
import jax.numpy as jnp

from distantspeech_tpu.runtime import StreamingProcessor, load_audio, load_pcm, pcmread, save_audio
from distantspeech_tpu.runtime.streaming import wav_chunks
from distantspeech_tpu.sim import RoomConfig, generate_scene, image_source_rir


def test_wav_roundtrip():
    x = np.sin(2 * np.pi * 440 * np.arange(16000) / 16000) * 0.5
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "tone.wav")
        save_audio(path, x)
        y = load_audio(path)
        np.testing.assert_allclose(y, x, atol=1e-4)


def test_pcm_read():
    x = (np.random.default_rng(0).standard_normal(1000) * 0.1 * 32768).astype(np.int16)
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "a.pcm")
        x.tofile(p)
        y = pcmread(p)
        np.testing.assert_allclose(y, x / 32768.0, atol=1e-9)
        stacked = load_pcm(d)
        assert stacked.shape == (1, 1000)


def test_streaming_processor_matches_offline():
    """Chunked streaming through the jitted step equals offline processing."""
    from distantspeech_tpu.transform import StftConfig
    from distantspeech_tpu.transform.stft import istft_stream, stft_stream, analysis, synthesis

    cfg = StftConfig(256, 128)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(128 * 40).astype(np.float32)

    def step(state, chunk):
        cin, cout = state
        cin, Y = stft_stream(cin, chunk, cfg)
        cout, y = istft_stream(cout, Y, cfg)
        return (cin, cout), y

    init = (jnp.zeros(cfg.overlap), jnp.zeros(cfg.overlap))
    proc = StreamingProcessor(step, init, chunk_size=512)
    out = proc.run(wav_chunks(x, 512))
    want = np.asarray(synthesis(analysis(jnp.asarray(x), cfg), cfg))
    np.testing.assert_allclose(out[: len(want)], want[: len(out)], atol=1e-5)
    assert proc.chunks == len(x) // 512


def test_image_source_rir_basics():
    cfg = RoomConfig(max_order=2)
    mics = np.array([[2.5, 1.5, 0.5], [2.53, 1.5, 0.5]])
    rir = image_source_rir(np.array([3.5, 1.5, 0.5]), mics, cfg)
    assert rir.shape[0] == 2 and np.isfinite(rir).all()
    # direct path: distance 1 m -> delay ~ fs/c ~ 46.6 samples, amp ~ 1/(4 pi)
    peak = np.argmax(np.abs(rir[0]))
    assert abs(peak - (1.0 / cfg.c * cfg.fs + 40)) < 45  # within the sinc half-width
    # closer mic louder direct path
    assert np.max(np.abs(rir[1])) > 0.9 * np.max(np.abs(rir[0]))


def test_generate_scene_snr():
    rng = np.random.default_rng(2)
    mics = np.stack([np.array([0.032 * m, 0, 0]) for m in range(4)], axis=0)
    src = rng.standard_normal(16000)
    mix = generate_scene(src, mics, snr=30, sir=15, cfg=RoomConfig(max_order=1))
    assert mix.shape == (4, 16000)
    assert np.isfinite(mix).all() and np.max(np.abs(mix)) < 10


def test_batched_rir_matches_host_ism():
    """The jitted batched ISM (sim/ism.py, the gpuRIR analogue) reproduces
    the host NumPy image-source model to float32 round-off."""
    from distantspeech_tpu.sim import batched_rir

    cfg = RoomConfig(max_order=2, rir_length=1600)
    rng = np.random.default_rng(3)
    mics = np.array([[2.5, 1.5, 0.5], [2.53, 1.5, 0.5], [2.56, 1.5, 0.5]])
    srcs = np.stack([
        np.array([3.5, 1.5, 0.5]),
        np.array([1.2, 2.1, 0.8]),
        np.array([4.1, 0.7, 1.2]),
        np.array([2.0, 1.0, 2.0]),
    ])

    got = np.asarray(batched_rir(jnp.asarray(srcs), jnp.asarray(mics), cfg))
    assert got.shape == (4, 3, 1600)
    for b in range(4):
        want = image_source_rir(srcs[b], mics, cfg)
        scale = np.max(np.abs(want))
        np.testing.assert_allclose(got[b], want, atol=2e-4 * scale, err_msg=f"src {b}")


def test_batched_propagation_matches_host():
    from distantspeech_tpu.sim import batched_propagation
    from distantspeech_tpu.sim.room import simulate_propagation

    cfg = RoomConfig(max_order=1, rir_length=900)
    rng = np.random.default_rng(4)
    mics = np.array([[2.5, 1.5, 0.5], [2.56, 1.5, 0.5]])
    srcs = np.array([[3.5, 1.5, 0.5], [1.5, 2.5, 1.0]])
    sig = rng.standard_normal((2, 4000)).astype(np.float32)

    got = np.asarray(batched_propagation(jnp.asarray(sig), jnp.asarray(srcs), jnp.asarray(mics), cfg))
    assert got.shape == (2, 2, 4000)
    for b in range(2):
        want = simulate_propagation(sig[b], srcs[b], mics, cfg)
        scale = np.max(np.abs(want))
        np.testing.assert_allclose(got[b], want, atol=5e-4 * scale, err_msg=f"src {b}")


def test_hybrid_rir_matches_sabine_rt60():
    """The diffuse-tail hybrid (the ArraySim ISM+ray-tracing analogue,
    ArraySim.py:166-238) must decay at the configured Sabine RT60: Schroeder
    backward integration of the -5..-35 dB range within 20%."""
    from distantspeech_tpu.array.geometry import ArrayGeometry
    from distantspeech_tpu.sim import RoomConfig, hybrid_rir, sabine_rt60

    cfg = RoomConfig(max_order=3, energy_absorption=0.3)
    geom = ArrayGeometry.linear(4, 0.05)
    center = np.array([2.5, 1.5, 0.5])
    rir = hybrid_rir(center + np.array([1.0, 0.5, 0.0]), geom.mic_loc + center, cfg, seed=0)

    t60 = sabine_rt60(cfg)
    for m in range(rir.shape[0]):
        e = rir[m] ** 2
        sch = 10 * np.log10(np.maximum(np.cumsum(e[::-1])[::-1] / e.sum(), 1e-30))
        i5, i35 = np.argmax(sch <= -5.0), np.argmax(sch <= -35.0)
        slope = (sch[i35] - sch[i5]) / (i35 - i5)
        rt60_est = -60.0 / slope / cfg.fs
        assert abs(rt60_est - t60) < 0.2 * t60, (m, rt60_est, t60)


def test_hybrid_scene_still_enhances():
    """End-to-end: the flagship still improves SI-SDR on a hybrid
    (ISM + diffuse-tail) scene — the hard-fixture regime."""
    import jax.numpy as jnp

    from distantspeech_tpu.array.geometry import ArrayGeometry
    from distantspeech_tpu.beamform.enhance import enhance_process
    from distantspeech_tpu.sim import RoomConfig, generate_scene
    from distantspeech_tpu.stats import best_aligned_si_sdr

    fs, S = 16000, 16000 * 2
    rng = np.random.default_rng(9)
    t = np.arange(S) / fs
    env = (np.sin(2 * np.pi * 0.6 * t + 0.7) > -0.2).astype(float)
    env[:12000] = 0.0
    k = np.hanning(9)
    src = np.convolve(rng.standard_normal(S), k / k.sum(), "same") * env

    geom = ArrayGeometry.linear(4, 0.05)
    mix = generate_scene(
        src, geom.mic_loc, interference=rng.standard_normal(S),
        source_angle=90.0, interf_angle=20.0, snr=15.0, sir=5.0,
        cfg=RoomConfig(max_order=3, energy_absorption=0.3), seed=3,
        diffuse_tail=True,
    ).astype(np.float32)
    y = np.asarray(enhance_process(jnp.asarray(mix), geom, (90.0, 0.0)))
    best_in = best_aligned_si_sdr(mix[0], src)
    best_out = best_aligned_si_sdr(y, src)
    assert best_out > best_in + 1.0, (best_in, best_out)
