"""Flagship benchmark: 8-mic adaptive MVDR + OM-LSA postfilter throughput.

    python bench.py

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.
The metric is audio-seconds of multichannel input processed per wall-clock
second on one GPU, for ``enhance_process(backend="pallas")`` (the Triton
frame-loop kernel) at B=64 utterances x 8 mics x 4 s at 16 kHz.  The
reference NumPy implementation runs at ~1x realtime on a CPU by its own
overflow check (realtime_processing.py:126-127), so ``vs_baseline`` is the
same number.

1. No GPU -> exit 1; it never falls back to the CPU.
2. PARITY GATES first, at the timed width: the kernel path against the
   plain ``lax.scan`` path with ``vad_guard`` off (rel < 1e-4: the same f32
   LDL arithmetic in another order) and in the benched config (rel < 2e-2:
   ``vad_guard`` compares the raw S/Smin ratio against a hard threshold, so
   a 1-ulp difference can flip a hold/update decision, after which the two
   runs legitimately diverge by ~1e-3).  A fast wrong answer fails the run.
3. TIMING: median slope over iteration pairs (``runtime.profiling``),
   synchronised with ``block_until_ready``; a non-positive slope or a rate
   above the sanity ceiling raises instead of printing.
"""

import json
import os
import sys

import numpy as np

SANITY_CEILING = 1.0e7  # audio-s/s per card; far above what the op mix allows
TIGHT_TOL = 1e-4
FLIP_TOL = 2e-2


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: no GPU found (JAX platform {dev.platform!r})", file=sys.stderr)
        return 1

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from distantspeech_tpu.array.geometry import ArrayGeometry
    from distantspeech_tpu.beamform.enhance import EnhanceConfig, enhance_process
    from distantspeech_tpu.beamform.mvdr import MvdrConfig
    from distantspeech_tpu.runtime.cache import enable_compile_cache
    from distantspeech_tpu.runtime.profiling import benchmark

    enable_compile_cache()
    fs, n_mics, batch, seconds = 16000, 8, 64, 4.0
    S = int(fs * seconds)
    geom = ArrayGeometry.linear(n_mics, 0.032, fs=fs)
    cfg = EnhanceConfig()
    cfg_nog = EnhanceConfig(
        mvdr=MvdrConfig(**{**cfg.mvdr.__dict__, "vad_guard": False}), alpha_xi=cfg.alpha_xi, gmin=cfg.gmin,
    )

    def fn(c, backend):
        return jax.jit(lambda x: enhance_process(x, geom, (90.0, 0.0), c, backend=backend))

    rng = np.random.default_rng(0)
    x = jax.device_put(rng.standard_normal((batch, n_mics, S)).astype(np.float32))

    def rel(c):
        got = np.asarray(fn(c, "pallas")(x), np.float64)
        want = np.asarray(fn(c, "scan")(x), np.float64)
        return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-20))

    for name, c, tol in (("guard off, tight", cfg_nog, TIGHT_TOL), ("benched config", cfg, FLIP_TOL)):
        err = rel(c)
        if not (np.isfinite(err) and err < tol):
            raise RuntimeError(f"parity gate FAILED ({name}): kernel vs scan rel error {err:.3e} (need < {tol:g})")
        print(f"parity gate ({name}): rel error {err:.3e} < {tol:g} ok", file=sys.stderr)

    audio_seconds = batch * seconds
    r = benchmark(fn(cfg, "pallas"), x, iters=20)
    value = audio_seconds / r["per_call_s"]
    if not (np.isfinite(value) and 0.0 < value < SANITY_CEILING):
        raise RuntimeError(f"implausible throughput {value:.6g} audio-s/s (ceiling {SANITY_CEILING:.0e})")
    print(json.dumps({
        "metric": "audio_seconds_per_second_8mic_mvdr_omlsa",
        "value": value,
        "unit": "audio-s/s/card",
        "vs_baseline": value,
        "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
