"""Parity on the reference's REAL recordings.

Every other parity suite runs on synthetic ``standard_normal`` signals; real
speech exercises different branches — MCRA minima windows riding
nonstationary energy, speech-presence actually toggling, CCAF clamps
binding, two-path transfers firing.  These tests run the ACTUAL reference
classes (via refutil) on slices of the recordings the reference ships
(/root/reference/example/test_audio/rec1 — a real 4-mic capture;
an101-mtms-arrA — the CMU 8-mic array recording; samples/audio_samples —
real speech) and assert the same frame-exact parity as the synthetic suite.
"""

import functools
import os

import numpy as np
import jax.numpy as jnp
import pytest

import refutil
from distantspeech_tpu.array.geometry import ArrayGeometry
from distantspeech_tpu.beamform import (
    FdGscConfig, MvdrConfig, SubbandGscConfig, TdGscConfig,
    fdgsc_process, mvdr_process, subband_gsc_process, tdgsc_process,
)
from distantspeech_tpu.kws import DualMicKwsConfig, kws_process
from distantspeech_tpu.runtime.io import load_audio

REC1 = "/root/reference/example/test_audio/rec1"
AN101 = "/root/reference/example/test_audio/an101-mtms-arrA"
SAMPLES = "/root/reference/samples/audio_samples"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(REC1), reason="reference recordings not mounted"
)


@functools.lru_cache(maxsize=None)
def _rec1(n_blocks=160, block=256):
    """[4, S] slice of the real 4-mic recording, windowed to the most
    energetic stretch so the parity run sees actual speech."""
    chans = [load_audio(os.path.join(REC1, f)) for f in sorted(os.listdir(REC1))]
    x = np.stack(chans).astype(np.float64)  # [4, 427680]
    S = n_blocks * block
    hop = 16000
    starts = range(0, x.shape[1] - S, hop)
    best = max(starts, key=lambda s: float(np.sum(x[:, s : s + S] ** 2)))
    return x[:, best : best + S]


@functools.lru_cache(maxsize=None)
def _an101(block=128):
    chans = [
        load_audio(os.path.join(AN101, f"an101-mtms-arrA {i}.wav")) for i in range(1, 9)
    ]
    x = np.stack(chans).astype(np.float64)
    S = x.shape[1] // block * block
    return x[:, :S]


def _mic_array(M=4, r=0.032):
    refutil.patch_beamformer_base()
    ma_mod = refutil.load("DistantSpeech.beamformer.MicArray")
    return ma_mod.MicArray(arrayType="circular", r=r, M=M)


def test_real_tdgsc_parity():
    """TDGSC.process on real 4-mic speech; also checks the MCRA speech
    presence actually toggles (both decisions occur) on this material."""
    mod = refutil.load("DistantSpeech.beamformer.TDGSC")
    ref = mod.TDGSC(_mic_array(), frameLen=256)
    x = _rec1()
    out_ref, p_ref, bm_ref = ref.process(x.T.copy())

    geom = ArrayGeometry.circular(4, 0.032, c=343.0)
    out, p, bm = tdgsc_process(jnp.asarray(x), geom, cfg=TdGscConfig(n_mics=4))
    np.testing.assert_allclose(np.asarray(bm).T, bm_ref, atol=1e-9)
    np.testing.assert_allclose(np.asarray(p).T, p_ref, atol=1e-8)
    np.testing.assert_allclose(np.asarray(out), out_ref, rtol=1e-6, atol=1e-9)
    p_np = np.asarray(p)
    assert p_np.max() > 0.9, "real speech should drive p high somewhere"
    assert p_np.min() < 0.1, "noise-only bins should keep p low"


def test_real_fdgsc_parity():
    """FDGSC on real speech, including the low-bin p pinning quirk and the
    CCAF clamp on the adaptive blocking matrix actually binding."""
    mod = refutil.load("DistantSpeech.beamformer.FDGSC")
    ref = mod.FDGSC(_mic_array(), frameLen=256)
    x = _rec1()
    res = ref.process(x.T.copy())
    out_ref, p_ref, bm_ref = res[0], res[1], res[4]

    geom = ArrayGeometry.circular(4, 0.032, c=343.0)
    out, p, bm = fdgsc_process(jnp.asarray(x), geom, cfg=FdGscConfig(n_mics=4))
    np.testing.assert_allclose(np.asarray(p).T, p_ref, atol=1e-8)
    np.testing.assert_allclose(np.asarray(bm).T, bm_ref, atol=1e-8)
    np.testing.assert_allclose(np.asarray(out), out_ref, rtol=1e-6, atol=1e-8)


def test_real_subband_gsc_parity():
    """SubbandGSC (McSpp speech presence + subband NLMS chains) on real
    4-mic speech."""
    fdgsc_mod = refutil.load("DistantSpeech.beamformer.FDGSC")
    if not hasattr(fdgsc_mod, "DelayObj"):
        flms_mod = refutil.load("DistantSpeech.adaptivefilter.FastFreqLms")
        fdgsc_mod.DelayObj = flms_mod.DelayObj
    mod = refutil.load("DistantSpeech.beamformer.SubbandGSC")
    ref = mod.SubbandGSC(_mic_array(), frameLen=256)
    x = _rec1(n_blocks=48)
    out_ref, _, bm_ref, p_ref, _ = ref.process(x.copy())

    geom = ArrayGeometry.circular(4, 0.032, c=343.0)
    out, p, bm = subband_gsc_process(jnp.asarray(x), geom, cfg=SubbandGscConfig(n_mics=4))
    np.testing.assert_allclose(np.asarray(p).T, p_ref, atol=3e-5)
    np.testing.assert_allclose(np.asarray(bm).T, bm_ref, atol=1e-7)
    np.testing.assert_allclose(np.asarray(out), out_ref, rtol=1e-5, atol=1e-7)


def test_real_mvdr_parity():
    """Adaptive MVDR + MCRA on the CMU an101 8-mic array recording."""
    refutil.patch_beamformer_base()
    ma_mod = refutil.load("DistantSpeech.beamformer.MicArray")
    adaptive = refutil.load("DistantSpeech.beamformer.adaptivebeamformer")
    mic = ma_mod.MicArray(arrayType="circular", r=0.032, M=8)
    x = _an101()
    ref_obj = adaptive.adaptivebeamfomer(mic, 256, 128, 256)
    orig_istft = ref_obj.transformer.istft
    ref_obj.transformer.istft = lambda Y: orig_istft(Y[:, :, None])
    y_ref = ref_obj.process(x, np.array([0.0, 0.0]), method=2)["data"]

    geom = ArrayGeometry.circular(8, 0.032, c=343.0)
    y = np.asarray(mvdr_process(jnp.asarray(x), geom, (0.0, 0.0), MvdrConfig()))
    np.testing.assert_allclose(y, y_ref, atol=1e-7)


def test_real_kws_parity():
    """Dual-mic KWS cleaner on two real mic channels."""
    refutil.patch_beamformer_base()
    ma_mod = refutil.load("DistantSpeech.beamformer.MicArray")
    kws_mod = refutil.load("DistantSpeech.kws.dual_mic_kws")
    mic = ma_mod.MicArray(arrayType="linear", r=0.04, M=2)
    ref = kws_mod.DualMicKws(mic, frameLen=256)
    x = _rec1()[:2]
    out_ref = ref.process(x.copy())
    out = np.asarray(kws_process(jnp.asarray(x), DualMicKwsConfig(frame_len=256)))
    np.testing.assert_allclose(out, out_ref, rtol=1e-7, atol=1e-10)


def test_real_full_stack_parity():
    """The composed AEC + KWS + TDGSC + OMLSA stack with REAL speech as both
    the far-end (aishell3 clean speech echoing through a synthetic room
    path) and the near-end mics (rec1): two-path AEC transfer logic and the
    OMLSA postfilter run on actual speech statistics."""
    from distantspeech_tpu.runtime.full_stack import FullStackConfig, full_stack_process

    refutil.patch_beamformer_base()
    ma_mod = refutil.load("DistantSpeech.beamformer.MicArray")
    aec_mod = refutil.load("DistantSpeech.adaptivefilter.aec")
    kws_mod = refutil.load("DistantSpeech.kws.dual_mic_kws")
    tdgsc_mod = refutil.load("DistantSpeech.beamformer.TDGSC")

    M, L = 4, 256
    x_near = _rec1(n_blocks=40)
    S = x_near.shape[1]
    far = load_audio(os.path.join(SAMPLES, "cleanspeech_aishell3.wav")).astype(np.float64)[:S]
    rng = np.random.default_rng(7)
    h = rng.standard_normal(64) * np.exp(-np.arange(64) / 12) * 0.3
    echo = np.convolve(far, h)[:S]
    x = x_near + echo[None, :]
    T = S // L

    aecs = [
        aec_mod.Aec(filter_len=512, mu=0.01, num_block=2, prop=True, two_path=True)
        for _ in range(M)
    ]
    echo_free = np.zeros((S, M))
    for n in range(T):
        blk = slice(n * L, (n + 1) * L)
        for m in range(M):
            out_ref, _ = aecs[m].update(far[blk].copy(), x[m, blk].copy())
            echo_free[blk, m] = np.squeeze(out_ref)
    mic2 = ma_mod.MicArray(arrayType="linear", r=0.04, M=2)
    kws_ref = kws_mod.DualMicKws(mic2, frameLen=L)
    kws_out_ref = kws_ref.process(echo_free[:, :2].T.copy())
    gsc_ref = tdgsc_mod.TDGSC(_mic_array(), frameLen=L)
    out_ref, _, _ = gsc_ref.process(echo_free.copy(), postfilter=True)

    geom = ArrayGeometry.circular(4, 0.032, c=343.0)
    cfg = FullStackConfig(n_mics=M, postfilter=True)
    out, kws_clean, _ = full_stack_process(
        jnp.asarray(x), jnp.asarray(far), geom, cfg=cfg
    )
    np.testing.assert_allclose(np.asarray(kws_clean), kws_out_ref, atol=1e-7)
    np.testing.assert_allclose(np.asarray(out), out_ref, rtol=1e-5, atol=1e-7)
