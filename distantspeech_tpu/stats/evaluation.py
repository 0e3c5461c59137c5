"""Signal-quality evaluation metrics.

Capability parity with the reference's demo-time perceptual hooks
(/root/reference/DistantSpeech/noise_estimation/mcspp_base.py:394-403 calls
pesq/pystoi when available); here the always-available objective metrics
are first-class, and the perceptual ones are optional wrappers gated on
their packages (absent in this image).

Host NumPy on purpose: these score outputs after device_get, they are not
part of any compiled pipeline.
"""

from __future__ import annotations

import numpy as np


def si_sdr(est: np.ndarray, ref: np.ndarray) -> float:
    """Scale-invariant SDR in dB (Le Roux et al. 2019), mean-removed."""
    n = min(len(est), len(ref))
    est = np.asarray(est[:n], dtype=np.float64)
    ref = np.asarray(ref[:n], dtype=np.float64)
    est = est - est.mean()
    ref = ref - ref.mean()
    a = float(np.dot(est, ref) / np.maximum(np.dot(ref, ref), 1e-20))
    num = np.sum((a * ref) ** 2)
    den = np.maximum(np.sum((est - a * ref) ** 2), 1e-20)
    return float(10.0 * np.log10(np.maximum(num, 1e-20) / den))


def best_aligned_si_sdr(est: np.ndarray, ref: np.ndarray, max_lag: int = 1024) -> float:
    """SI-SDR maximised over a two-sided lag search: enhanced outputs lag
    their references by an unknown pipeline-dependent number of samples
    (RIR delay + transform latency), and trimming conventions can also make
    the estimate *lead*.  Lags that would leave no overlap are skipped.

    ``max_lag`` must cover the largest pipeline latency being scored:
    SubbandGSC delays its FBF path by a full frame before the AIC
    (SubbandGSC.py:139 — ours: ops.delay.delay_samples in subband_gsc_step)
    and the n_fft=512 STFT round-trip adds another 256, so its output lags
    ~512 samples.  The old 400-sample default missed that, and a merely
    *delayed* output scored as decorrelated: the round-4 real-speech
    "subband_gsc −21.4 dB" result was THIS metric artifact (both our and the
    reference's outputs, delayed identically, scored −21); at a covering
    lag the same outputs score ≈ +0.5 dB."""
    n = min(len(est), len(ref))
    best = -np.inf
    for l in range(min(max_lag, n)):
        # est delayed by l samples relative to ref ...
        best = max(best, si_sdr(est[l:], ref[: len(ref) - l] if l else ref))
        # ... and est leading ref by l samples
        if l:
            best = max(best, si_sdr(est[: len(est) - l], ref[l:]))
    return best


def snr_db(signal: np.ndarray, noise: np.ndarray) -> float:
    """Energy ratio in dB of aligned signal/noise components."""
    n = min(len(signal), len(noise))
    return float(
        10.0
        * np.log10(
            np.maximum(np.sum(np.asarray(signal[:n], np.float64) ** 2), 1e-20)
            / np.maximum(np.sum(np.asarray(noise[:n], np.float64) ** 2), 1e-20)
        )
    )


def segmental_snr_db(est: np.ndarray, ref: np.ndarray, frame: int = 256, floor=(-10.0, 35.0)) -> float:
    """Mean per-frame SNR in dB, clamped to ``floor`` like classic segSNR."""
    n = min(len(est), len(ref)) // frame * frame
    e = np.asarray(est[:n], np.float64).reshape(-1, frame)
    r = np.asarray(ref[:n], np.float64).reshape(-1, frame)
    num = np.sum(r**2, axis=1)
    den = np.maximum(np.sum((e - r) ** 2, axis=1), 1e-20)
    seg = 10.0 * np.log10(np.maximum(num, 1e-20) / den)
    return float(np.mean(np.clip(seg, *floor)))


def pesq_score(ref: np.ndarray, est: np.ndarray, fs: int = 16000) -> float:
    """PESQ via the optional ``pesq`` package (mcspp_base.py:394-398)."""
    try:
        from pesq import pesq
    except ImportError as e:  # pragma: no cover - package absent in CI image
        raise ImportError("pesq is not installed; use si_sdr/segmental_snr_db instead") from e
    return float(pesq(fs, np.asarray(ref), np.asarray(est), "wb"))


def stoi_score(ref: np.ndarray, est: np.ndarray, fs: int = 16000, extended: bool = False) -> float:
    """STOI via the optional ``pystoi`` package (mcspp_base.py:399-403)."""
    try:
        from pystoi import stoi
    except ImportError as e:  # pragma: no cover - package absent in CI image
        raise ImportError("pystoi is not installed; use si_sdr/segmental_snr_db instead") from e
    return float(stoi(np.asarray(ref), np.asarray(est), fs, extended=extended))
