"""On-card smoke test: the 8-mic MVDR + OM-LSA flagship end to end on a GPU.

    python chip_smoke.py              # one card: phases (a)-(f)
    python chip_smoke.py --cards 4    # the multi-card runners only

Phases (one card):

(a) device: JAX platform, device kind and count, the card's name and power
    limit from ``nvidia-smi``; no GPU -> exit 1 (never falls back to the CPU);
(b) the flagship at full width (B=64 utterances x 8 mics x 4 s at 16 kHz,
    n_fft 256 / hop 128) through ``enhance_process`` for both backends:
    compile seconds, ``memory_analysis()``, finite output of the right shape;
(c) gates: kernel vs scan at full width with ``vad_guard`` off (rel < 1e-4)
    and in the benched config (decision-flip tolerance, rel < 2e-2); the scan
    on the GPU vs the same scan on the host CPU backend (2 x 1 s, guard off,
    rel < 1e-3 — catches TF32 in unpinned dots);
(d) the CLI on a synthesized 8-channel scene: ``--pipeline enhance`` offline
    and ``--stream`` (latency report with the card named);
(e) every other CLI pipeline once on a 2 s scene: finite output, first- and
    second-call seconds;
(f) throughput of both backends in audio-s/s on one card.

``--cards 4`` runs only ``make_sharded_enhance`` on a dp=4 mesh and on a
bin-sharded dp=1 x fb=4 mesh, plus the kernel runner, each against the
single-card scan on the same batch.

The last stdout line is one JSON object {"ok": true, "device": {...}};
any failure exits non-zero before it is printed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

FS = 16000
N_MICS = 8
BATCH = 64
SECONDS = 4.0
TIGHT_TOL = 1e-4  # kernel vs scan, guard off: same f32 LDL arithmetic, other order
FLIP_TOL = 2e-2  # benched config: vad_guard decisions may flip on 1-ulp differences
HOST_TOL = 1e-3  # GPU scan vs CPU scan: f32 rounding, no TF32


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-20))


def gate(name: str, err: float, tol: float) -> None:
    ok = np.isfinite(err) and err < tol
    log(f"gate {name}: rel error {err:.3e} (tolerance {tol:.0e}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit(f"chip_smoke: gate {name} failed")


def check_output(name: str, y, shape=None) -> np.ndarray:
    """Finite values (and ``shape``, where given) or exit."""
    y = np.asarray(y)
    if (shape is not None and y.shape != tuple(shape)) or not np.isfinite(y).all():
        raise SystemExit(f"chip_smoke: {name} output shape {y.shape} (want {shape}), "
                         f"finite={bool(np.isfinite(y).all())}")
    return y


def device_check(n_cards: int):
    import jax

    devs = jax.devices()
    d = devs[0]
    log(f"device: platform={d.platform} kind={d.device_kind} count={len(devs)}")
    if d.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU found (JAX platform {d.platform!r})")
    if len(devs) < n_cards:
        raise SystemExit(f"chip_smoke: {n_cards} cards asked for, {len(devs)} found")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    for line in smi.stdout.strip().splitlines():
        log(f"nvidia-smi: {line.strip()}")
    if smi.returncode != 0:
        raise SystemExit(f"chip_smoke: nvidia-smi failed: {smi.stderr.strip()}")
    return devs


def flagship_fn(cfg, geom, backend):
    import jax

    from distantspeech_tpu.beamform.enhance import enhance_process

    return jax.jit(lambda x: enhance_process(x, geom, (90.0, 0.0), cfg, backend=backend))


def compile_timed(name, fn, x):
    t0 = time.perf_counter()
    lowered = fn.lower(x)
    t1 = time.perf_counter()
    compiled = lowered.compile()
    t2 = time.perf_counter()
    log(f"compile {name}: trace+lower {t1 - t0:.2f} s, compile {t2 - t1:.2f} s")
    return compiled


def memory_line(name, compiled) -> None:
    m = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    log(f"memory {name}: " + ", ".join(f"{f}={getattr(m, f, None)}" for f in fields))


def out_shape_of(fn, x, cfg):
    """The pipeline's output shape: [B, S'] with S' within one frame of S."""
    import jax

    shape = jax.eval_shape(fn, x).shape
    B, _, S = x.shape
    if len(shape) != 2 or shape[0] != B or not S - cfg.stft.n_fft < shape[1] <= S:
        raise SystemExit(f"chip_smoke: flagship output shape {shape} for input {x.shape}")
    return shape


def configs():
    from distantspeech_tpu.beamform.enhance import EnhanceConfig
    from distantspeech_tpu.beamform.mvdr import MvdrConfig

    cfg = EnhanceConfig()
    nog = EnhanceConfig(
        mvdr=MvdrConfig(**{**cfg.mvdr.__dict__, "vad_guard": False}), alpha_xi=cfg.alpha_xi, gmin=cfg.gmin
    )
    return cfg, nog


def single_card(args) -> None:
    import jax

    from distantspeech_tpu.array.geometry import ArrayGeometry
    from distantspeech_tpu.runtime.profiling import benchmark

    geom = ArrayGeometry.linear(N_MICS, 0.032, fs=FS)
    cfg, nog = configs()
    S = int(FS * SECONDS)
    rng = np.random.default_rng(args.seed)
    x = jax.device_put(rng.standard_normal((BATCH, N_MICS, S)).astype(np.float32))

    # (b) flagship at full width, both backends, benched config
    log(f"== (b) flagship B={BATCH} M={N_MICS} {SECONDS:g} s, n_fft {cfg.stft.n_fft} hop {cfg.stft.hop}")
    out_shape = out_shape_of(flagship_fn(cfg, geom, "scan"), x, cfg)
    runs = {}
    for backend in ("scan", "pallas"):
        comp = compile_timed(f"{backend}", flagship_fn(cfg, geom, backend), x)
        memory_line(backend, comp)
        t0 = time.perf_counter()
        y = comp(x)
        y.block_until_ready()
        log(f"first run {backend}: {time.perf_counter() - t0:.3f} s")
        runs[backend] = (comp, check_output(f"flagship {backend}", y, out_shape))

    # (c) gates
    log("== (c) gates")
    ys = {}
    for backend in ("scan", "pallas"):
        comp = compile_timed(f"{backend} guard-off", flagship_fn(nog, geom, backend), x)
        ys[backend] = check_output(f"guard-off {backend}", comp(x), out_shape)
    gate("kernel vs scan, guard off, full width", rel_err(ys["pallas"], ys["scan"]), TIGHT_TOL)
    gate("kernel vs scan, benched config, full width", rel_err(runs["pallas"][1], runs["scan"][1]), FLIP_TOL)
    x2 = rng.standard_normal((2, N_MICS, FS)).astype(np.float32)
    scan2 = flagship_fn(nog, geom, "scan")
    shape2 = out_shape_of(scan2, x2, cfg)
    y_gpu = check_output("scan 2x1s gpu", scan2(jax.device_put(x2, jax.devices()[0])), shape2)
    y_cpu = check_output("scan 2x1s cpu", scan2(jax.device_put(x2, jax.devices("cpu")[0])), shape2)
    gate("scan GPU vs host CPU, 2 x 1 s, guard off", rel_err(y_gpu, y_cpu), HOST_TOL)

    # (d) + (e) the CLI
    cli_phases(args)

    # (f) throughput
    log("== (f) throughput")
    audio_s = BATCH * SECONDS
    for backend in ("scan", "pallas"):
        r = benchmark(runs[backend][0], x, iters=8)
        log(f"throughput {backend}: {audio_s / r['per_call_s']:.1f} audio-s/s "
            f"({r['per_call_s'] * 1e3:.3f} ms per {BATCH} x {SECONDS:g} s batch)")


def scene(seconds: float, seed: int) -> np.ndarray:
    """Reverberant 8-mic scene from the examples' generator: a nonstationary
    speech-band target at 90 deg plus an interferer, [8, S]."""
    sys.path.insert(0, os.path.join(REPO, "examples"))
    from _common import make_scene

    return make_scene(n_mics=N_MICS, fs=FS, dur=seconds, seed=seed)[0]


def cli_phases(args) -> None:
    import jax

    from distantspeech_tpu.runtime import cli
    from distantspeech_tpu.runtime.io import save_audio

    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    log("== (d) CLI enhance, offline and --stream")
    wav4 = os.path.join(out, "scene_8ch_4s.wav")
    save_audio(wav4, scene(4.0, args.seed).T * 0.5)
    t0 = time.perf_counter()
    y = cli.main([wav4, os.path.join(out, "enhance.wav"), "--pipeline", "enhance"])
    check_output("cli enhance", y)
    log(f"cli enhance offline: {time.perf_counter() - t0:.2f} s, {y.shape[-1]} samples")
    lat = os.path.join(out, "enhance_stream.latency.json")
    y = cli.main([wav4, os.path.join(out, "enhance_stream.wav"), "--pipeline", "enhance", "--stream",
                  "--latency-json", lat])
    check_output("cli enhance --stream", y)
    with open(lat) as f:
        report = json.load(f)
    if report.get("device", {}).get("kind") != jax.devices()[0].device_kind:
        raise SystemExit(f"chip_smoke: stream report names another device: {report.get('device')}")
    log(f"cli stream latency report: {lat}")

    log("== (e) every other CLI pipeline, 2 s scene")
    wav2 = os.path.join(out, "scene_8ch_2s.wav")
    save_audio(wav2, scene(2.0, args.seed + 1).T * 0.5)
    choices = [a for a in cli.build_parser()._actions if a.dest == "pipeline"][0].choices
    for name in choices:
        if name == "enhance":
            continue
        dst = os.path.join(out, f"{name}.wav")
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            y = cli.main([wav2, dst, "--pipeline", name])
            times.append(time.perf_counter() - t0)
        check_output(f"cli {name}", y)
        log(f"cli {name}: first call {times[0]:.2f} s (compile + run), second {times[1]:.2f} s, "
            f"output {y.shape}")


def four_cards(args) -> None:
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from distantspeech_tpu.array.geometry import ArrayGeometry
    from distantspeech_tpu.parallel import make_mesh, make_sharded_enhance, make_sharded_enhance_pallas
    from distantspeech_tpu.runtime.profiling import benchmark

    geom = ArrayGeometry.linear(N_MICS, 0.032, fs=FS)
    S = int(FS * SECONDS)
    rng = np.random.default_rng(args.seed)
    x_host = rng.standard_normal((BATCH, N_MICS, S)).astype(np.float32)
    devs = jax.devices()[:4]
    cfg, nog = configs()
    ref_fn = flagship_fn(nog, geom, "scan")
    shape = out_shape_of(ref_fn, x_host, cfg)
    ref = check_output("single-card scan", ref_fn(jax.device_put(x_host, devs[0])), shape)
    audio_s = BATCH * SECONDS
    for label, (n_dp, n_fb), maker in (
        ("scan dp=4", (4, 1), make_sharded_enhance),
        ("scan dp=1 x fb=4", (1, 4), make_sharded_enhance),
        ("kernel dp=4", (4, 1), make_sharded_enhance_pallas),
        ("kernel dp=1 x fb=4", (1, 4), make_sharded_enhance_pallas),
    ):
        mesh = make_mesh(n_dp, n_fb, devices=devs)
        run = maker(mesh, geom, (90.0, 0.0), nog)
        # the batch lives on the cards in the runner's input sharding, as the
        # one-card timing's does: no host transfer inside the timed calls
        x = jax.device_put(x_host, NamedSharding(mesh, P("dp", None, None)))
        t0 = time.perf_counter()
        y = check_output(label, run(x), shape)
        log(f"{label}: first call {time.perf_counter() - t0:.2f} s")
        gate(f"{label} vs single-card scan", rel_err(y, ref), TIGHT_TOL)
        r = benchmark(run, x, iters=8)
        log(f"throughput {label}: {audio_s / r['per_call_s']:.1f} audio-s/s on 4 cards")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-card runners against the single-card scan")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(REPO, "results", "chip_smoke"),
                    help="directory for the CLI phases' wavs and latency report")
    args = ap.parse_args(argv)

    devs = device_check(args.cards)
    sys.path.insert(0, REPO)
    from distantspeech_tpu.runtime.cache import cache_entries, enable_compile_cache

    cache = enable_compile_cache()
    log(f"compile cache: {cache} ({cache_entries(cache)} entries at start)")
    t0 = time.perf_counter()
    if args.cards == 4:
        four_cards(args)
    else:
        single_card(args)
    log(f"compile cache: {cache_entries(cache)} entries at end; total {time.perf_counter() - t0:.1f} s")
    d = devs[0]
    print(json.dumps({"ok": True, "device": {"platform": d.platform, "kind": d.device_kind,
                                             "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
