"""Device-facing runtime: the on-card scripts refuse to run without a GPU,
the compile cache goes where it should, reports name their device, and the
complex contractions on the GPU path pin full float32 precision."""

import os
import shutil
import subprocess
import sys

import numpy as np
import jax
import jax.extend
import jax.numpy as jnp
import pytest

from distantspeech_tpu.runtime import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_cpu(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, script], cwd=cwd, capture_output=True, text=True, timeout=240, env=env)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    """No accelerator: non-zero exit and no result line, whether it runs
    in the checkout or copied into a directory that holds nothing else."""
    cwd = REPO
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
        cwd = str(tmp_path)
    res = _run_cpu("chip_smoke.py", cwd)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "no GPU" in res.stderr


def test_bench_fails_without_gpu():
    res = _run_cpu("bench.py", REPO)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "no GPU" in res.stderr


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # JAX's own setting, untouched


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    try:
        assert cache.enable_compile_cache() == cache.DEFAULT_DIR
        assert jax.config.jax_compilation_cache_dir == cache.DEFAULT_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert os.path.dirname(cache.DEFAULT_DIR) == REPO
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert os.path.basename(cache.DEFAULT_DIR) + "/" in f.read().split()


def test_cache_entries_counts_files(tmp_path):
    assert cache.cache_entries(str(tmp_path / "missing")) == 0
    (tmp_path / "a").write_bytes(b"x")
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "b").write_bytes(b"y")
    assert cache.cache_entries(str(tmp_path)) == 2


def test_latency_report_names_device():
    from distantspeech_tpu.runtime.streaming import StreamingProcessor

    proc = StreamingProcessor(lambda s, c: (s, c.sum(axis=0)), jnp.zeros(()), chunk_size=64)
    proc.run(iter([np.ones((2, 64), np.float32)] * 3))
    dev = proc.latency_report()["device"]
    assert dev == {"platform": "cpu", "kind": jax.devices()[0].device_kind, "count": len(jax.devices())}


def _dot_precisions(closed):
    """Precision config of every dot_general in a jaxpr, sub-jaxprs included."""
    out = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in v if isinstance(v, (tuple, list)) else (v,):
                    if isinstance(sub, jax.extend.core.ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, jax.extend.core.Jaxpr):
                        walk(sub)

    walk(closed.jaxpr)
    return out


def _contractions():
    from distantspeech_tpu.array.geometry import ArrayGeometry
    from distantspeech_tpu.beamform.fixed import apply_weights
    from distantspeech_tpu.beamform.mvdr import adaptive_mvdr2_process
    from distantspeech_tpu.doa.srp import srp_angle_spectrum
    from distantspeech_tpu.stats.metrics import array_gain, beampattern
    from distantspeech_tpu.stats.weights import blind_analytic_normalization, gev_weights
    from distantspeech_tpu.transform import StftConfig, analysis, synthesis

    rng = np.random.default_rng(0)
    c = lambda *s: jnp.asarray(rng.standard_normal(s) + 1j * rng.standard_normal(s), jnp.complex64)
    eye = jnp.eye(4, dtype=jnp.complex64)
    R = lambda: (lambda a: a @ jnp.conj(jnp.swapaxes(a, -1, -2)) + eye)(c(9, 4, 4))
    geom = ArrayGeometry.linear(4, 0.032)
    cfg = StftConfig(16, 8)
    return {
        "fixed_apply_weights": (apply_weights, (c(9, 4), c(2, 4, 5, 9))),
        "mvdr2_frozen_weights": (
            lambda x, a: adaptive_mvdr2_process(x, a, frame_len=16, hop=8, n_est_frames=3),
            (jnp.asarray(rng.standard_normal((4, 96)), jnp.float32), c(9, 4))),
        "srp_angle_spectrum": (srp_angle_spectrum, (c(5, 9, 4), c(12, 9, 4))),
        "ban": (blind_analytic_normalization, (c(9, 4), R())),
        "gev": (gev_weights, (R(), R())),
        "array_gain": (array_gain, (c(9, 4), c(9, 4), R())),
        "beampattern": (lambda w: beampattern(geom, w, 16), (c(9, 4),)),
        "stft_roundtrip": (lambda x: synthesis(analysis(x, cfg), cfg),
                           (jnp.asarray(rng.standard_normal((2, 64)), jnp.float32),)),
    }


@pytest.mark.parametrize("name", list(_contractions()))
def test_dots_pin_highest_precision(name):
    """On the GPU an unpinned float32 dot may run in TF32 (~3 digits): every
    contraction on these paths asks for full precision."""
    fn, args = _contractions()[name]
    precisions = _dot_precisions(jax.make_jaxpr(fn)(*args))
    assert precisions, f"{name}: no dot_general traced"
    for p in precisions:
        assert p is not None and all(q == jax.lax.Precision.HIGHEST for q in p), (name, p)
