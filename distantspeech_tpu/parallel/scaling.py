"""Scaling harness: audio-seconds/s across mesh shapes (SURVEY §7.8).

Measures the sharded flagship pipeline at a list of ('dp', 'fb') mesh
shapes over however many devices exist — one GPU, the cards of one host,
a virtual CPU mesh, or several hosts (initialise jax.distributed before
calling and the same code runs across them).

Beyond raw throughput, each shape reports:

- ``efficiency``: for dp (weak scaling, batch grows with devices) the
  per-device throughput relative to the 1x1 baseline; for fb (strong
  scaling, fixed problem) the speedup over 1x1 divided by devices.
- ``collectives``: static count and payload bytes of every communication
  op in the COMPILED HLO — the proof of what the sharding actually costs.
  Counts are per-executable instances; ops inside the frame scan execute
  once per frame, so the *shape* of the story is: tiny per-frame halo
  (collective-permute of one bin column) + one-off edge redistributes
  (all-to-all / all-gather around analysis/synthesis).
"""

from __future__ import annotations

import re
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from distantspeech_tpu.array.geometry import ArrayGeometry
from distantspeech_tpu.beamform.enhance import EnhanceConfig
from distantspeech_tpu.parallel.mesh import make_mesh
from distantspeech_tpu.parallel.sharded import make_sharded_enhance
from distantspeech_tpu.runtime.profiling import slope_per_iter

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8": 1,
    "c128": 16, "c64": 8,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1,
    "u64": 8, "u32": 4, "u16": 2, "u8": 1, "pred": 1,
}

_COLLECTIVE_RE = re.compile(
    r"=\s*\(?\s*(\w+)\[([\d,]*)\]"  # result dtype[dims] (first element if tuple)
    r".*?\b"
    r"(all-reduce|all-gather|reduce-scatter|collective-permute|all-to-all|collective-broadcast)"
    r"(?:-start)?\("
)


def collective_stats(hlo_text: str) -> Dict[str, Dict[str, int]]:
    """Count communication ops and payload bytes in compiled HLO text.

    Static instruction counts with scan attribution: ops inside a ``while``
    body/condition computation (how XLA compiles ``lax.scan``) execute once
    PER FRAME and are reported separately as ``count_per_step`` /
    ``bytes_per_step``; the rest run once per call (edge redistributes).
    ``bytes`` is the per-execution payload of the op's (first) result buffer.
    """
    lines = hlo_text.splitlines()
    # pass 1: computations that are while-loop bodies/conditions (lax.scan
    # compiles to while; XLA names the regions %region_N, so they must be
    # found via the while op's body=/condition= attributes)
    loop_comps = set()
    for ln in lines:
        if " while(" in ln or " while-" in ln:
            for m in re.finditer(r"(?:body|condition)=%?([\w\.\-]+)", ln):
                loop_comps.add(m.group(1))
    # pass 2: attribute each collective to its enclosing computation
    out: Dict[str, Dict[str, int]] = {}
    comp = ""
    for line in lines:
        s = line.strip()
        if s.endswith("{") and (") -> " in s or s.startswith("ENTRY")):
            tok = s.split()[1] if s.startswith("ENTRY") else s.split()[0]
            comp = tok.lstrip("%")
        m = _COLLECTIVE_RE.search(line)
        if not m:
            continue
        dtype, dims, op = m.group(1), m.group(2), m.group(3)
        n = int(np.prod([int(d) for d in dims.split(",") if d])) if dims else 1
        nbytes = n * _DTYPE_BYTES.get(dtype, 4)
        slot = out.setdefault(op, {"count": 0, "bytes": 0, "count_per_step": 0, "bytes_per_step": 0})
        if comp in loop_comps:
            slot["count_per_step"] += 1
            slot["bytes_per_step"] += nbytes
        else:
            slot["count"] += 1
            slot["bytes"] += nbytes
    return out


def measure_scaling(
    mesh_shapes: Optional[List[Tuple[int, int]]] = None,
    batch_per_dp: int = 8,
    n_mics: int = 8,
    seconds: float = 4.0,
    fs: int = 16000,
    iters: int = 6,
    with_collectives: bool = True,
) -> List[Dict]:
    """Run the flagship pipeline at each mesh shape; returns metric dicts.

    ``efficiency`` semantics: dp scales the batch (weak scaling), so it is
    per-device throughput over the 1x1 baseline; fb splits a fixed problem
    (strong scaling), so it is speedup/devices.  On a virtual CPU mesh the
    "devices" share one host's cores, so efficiency conflates communication
    with plain core contention — the ``collectives`` field separates them by
    showing what communication the compiled program actually contains.
    """
    n_dev = len(jax.devices())
    if mesh_shapes is None:
        mesh_shapes = [(1, 1)]
        if n_dev > 1:
            mesh_shapes += [(1, n_dev), (n_dev, 1)]
            if n_dev % 2 == 0:
                mesh_shapes.append((2, n_dev // 2))

    geom = ArrayGeometry.linear(n_mics, 0.032, fs=fs)
    S = int(fs * seconds) // 128 * 128
    results = []
    base_rate = None
    for (dp, fb) in mesh_shapes:
        if dp * fb > n_dev:
            continue
        mesh = make_mesh(dp, fb, devices=jax.devices()[: dp * fb])
        run = make_sharded_enhance(mesh, geom, (90.0, 0.0), EnhanceConfig())
        B = batch_per_dp * dp
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.standard_normal((B, n_mics, S)).astype(np.float32))

        def timed(n):
            t0 = time.perf_counter()
            for _ in range(n):
                y = run(x)
            y.block_until_ready()
            return time.perf_counter() - t0

        timed(1)
        timed(1)
        n1 = max(1, iters // 3)
        per, _ = slope_per_iter(
            timed,
            pairs=((n1, iters), (n1 + 1, iters + 1), (n1 + 2, iters + 2)),
            min_per_iter=B * seconds / 1.0e6,
        )
        rate = B * seconds / per
        entry = {
            "mesh": f"{dp}x{fb}",
            "devices": dp * fb,
            "batch": B,
            "audio_seconds_per_s": rate,
        }
        if base_rate is None and dp * fb == 1:
            base_rate = rate
        if base_rate is not None:
            # batch scales with dp, so ideal throughput is base * dp * fb in
            # every mode: dp multiplies work done (weak), fb divides the time
            # a fixed problem takes (strong)
            entry["efficiency"] = round(rate / (base_rate * dp * fb), 3)
            entry["scaling_mode"] = (
                "baseline" if dp * fb == 1
                else "weak(dp)" if fb == 1
                else "strong(fb)" if dp == 1
                else "mixed"
            )
        if with_collectives:
            try:
                hlo = run.lower(x).compile().as_text()
                entry["collectives"] = collective_stats(hlo)
            except Exception as e:  # pragma: no cover - lowering API drift
                entry["collectives"] = {"error": str(e)}
        results.append(entry)
    return results


def runner_collectives(n_mics: int = 4, fs: int = 16000) -> Dict[str, Dict]:
    """Collective attribution for EVERY sharded runner's compiled HLO — the
    "negligible comms" claim, checked per program that actually ships
    sharded.  The kernel runner's shard_map region must show zero
    collectives; the fb-sharded runners show the per-frame halo + edge
    redistributes.  Runs on whatever devices exist; the kernel runner's row
    records an error where they are not CUDA GPUs.
    """
    from distantspeech_tpu.beamform.gsc import GscConfig
    from distantspeech_tpu.beamform.subband_gsc import SubbandGscConfig
    from distantspeech_tpu.derev.wpe import WpeConfig
    from distantspeech_tpu.parallel.sharded import (
        make_sharded_enhance_pallas, make_sharded_gsc, make_sharded_subband_gsc, make_sharded_wpe,
    )

    n_dev = len(jax.devices())
    dp = 2 if n_dev % 2 == 0 and n_dev > 1 else 1
    mesh = make_mesh(dp, n_dev // dp)
    geom = ArrayGeometry.linear(n_mics, 0.032, fs=fs)
    ang = (197.0 / 180.0 * np.pi, 0.0)
    rng = np.random.default_rng(0)

    def x_of(B, C, S):
        return jnp.asarray(rng.standard_normal((B, C, S)).astype(np.float32))

    cases = {
        "enhance_scan": (make_sharded_enhance(mesh, geom, (90.0, 0.0), EnhanceConfig()),
                         x_of(2 * dp, n_mics, 128 * 8)),
        "enhance_pallas": (make_sharded_enhance_pallas(mesh, geom, (90.0, 0.0), EnhanceConfig()),
                           x_of(2 * dp, n_mics, 128 * 8)),
        "wpe": (make_sharded_wpe(mesh, WpeConfig(num_bands=64, hop=32, n_channels=2, filter_len=2, delay=2)),
                x_of(2 * dp, 2, 32 * 12)),
        "subband_gsc": (make_sharded_subband_gsc(mesh, geom, ang, SubbandGscConfig(n_mics=n_mics, frame_len=128)),
                        x_of(2 * dp, n_mics, 128 * 3)),
        "gsc": (make_sharded_gsc(mesh, geom, ang, GscConfig(n_mics=n_mics)),
                x_of(2 * dp, n_mics, 128 * 3)),
    }
    out = {}
    for name, (run, x) in cases.items():
        try:
            hlo = run.lower(x).compile().as_text()
            out[name] = {"mesh": f"{dp}x{n_dev // dp}", **{"collectives": collective_stats(hlo)}}
        except Exception as e:  # pragma: no cover - lowering API drift
            out[name] = {"error": f"{type(e).__name__}: {e}"[:200]}
    return out


if __name__ == "__main__":
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="write the JSON artifact here")
    ap.add_argument("--cpu-virtual", type=int, default=0,
                    help="force a virtual CPU mesh with this many devices")
    args = ap.parse_args()
    if args.cpu_virtual:
        import os

        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.cpu_virtual}"
        )
        jax.config.update("jax_platforms", "cpu")

    results = measure_scaling()
    runners = runner_collectives()
    artifact = {
        "version": 3,
        "platform": f"{jax.devices()[0].platform}-{len(jax.devices())}dev",
        "note": (
            "mesh-shape sweep; efficiency is throughput / (1x1 baseline * devices); "
            "collectives are static op counts + payload bytes from the compiled HLO "
            "(ops inside the frame scan execute once per frame). On a virtual CPU "
            "mesh, devices share one host's cores, so efficiency below 1 reflects "
            "core contention + per-step overhead, NOT communication volume."
        ),
        "results": results,
        "runner_collectives": runners,
    }
    text = json.dumps(artifact, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
