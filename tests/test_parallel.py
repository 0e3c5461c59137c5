"""Multi-chip sharding tests on the 8-device CPU mesh (the JAX fake cluster)."""

import numpy as np
import jax
import jax.numpy as jnp

from distantspeech_tpu.array.geometry import ArrayGeometry
from distantspeech_tpu.beamform.enhance import EnhanceConfig, enhance_process
from distantspeech_tpu.parallel import make_mesh, make_sharded_enhance


def test_sharded_enhance_matches_single_device():
    assert len(jax.devices()) == 8
    geom = ArrayGeometry.linear(4, 0.032)
    cfg = EnhanceConfig()
    rng = np.random.default_rng(0)
    B, M, S = 4, 4, 128 * 24
    x = rng.standard_normal((B, M, S)).astype(np.float32)

    want = np.asarray(enhance_process(jnp.asarray(x), geom, (90.0, 0.0), cfg))

    for n_dp, n_fb in [(1, 8), (2, 4), (4, 2)]:
        mesh = make_mesh(n_dp, n_fb)
        run = make_sharded_enhance(mesh, geom, (90.0, 0.0), cfg)
        got = np.asarray(run(jnp.asarray(x)))
        # atol 5e-4, not 2e-5: the default vad_guard compares the RAW
        # S/Smin ratio against delta_s every frame, so a 1-ulp fusion
        # difference between the complex scan and the split-real kernel can
        # flip a single Rvv hold/update and the held state drifts ~1e-4
        # (measured; with vad_guard=False the paths agree to 2e-7).
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=5e-4, err_msg=f"mesh {n_dp}x{n_fb}")


def test_sharded_enhance_batch_sharded_inputs():
    """Inputs already placed shard-wise must produce identical results."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    geom = ArrayGeometry.linear(4, 0.032)
    mesh = make_mesh(2, 4)
    run = make_sharded_enhance(mesh, geom)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 4, 128 * 10)).astype(np.float32)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("dp", None, None)))
    got = np.asarray(run(xs))
    want = np.asarray(run(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_sharded_gsc_matches_single_device():
    from distantspeech_tpu.beamform.gsc import GscConfig, gsc_process
    from distantspeech_tpu.parallel.sharded import make_sharded_gsc

    geom = ArrayGeometry.circular(4, 0.032)
    cfg = GscConfig(n_mics=4, frame_len=256)
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((4, 4, 256 * 8)) * 0.1).astype(np.float32)
    angle = (197.0 / 180.0 * np.pi, 0.0)

    want = np.asarray(gsc_process(jnp.asarray(x), geom, angle, cfg))
    mesh = make_mesh(2, 4)
    run = make_sharded_gsc(mesh, geom, angle, cfg)
    got = np.asarray(run(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_sharded_wpe_matches_single_device():
    """The [B, F, CN, CN] RLS-WPE P recursion bin-shards collective-free."""
    from distantspeech_tpu.derev.wpe import WpeConfig, wpe_process
    from distantspeech_tpu.parallel import make_sharded_wpe

    cfg = WpeConfig(num_bands=64, hop=32, n_channels=2, filter_len=2, delay=2)
    rng = np.random.default_rng(4)
    B, C, S = 4, 2, 32 * 40
    x = (rng.standard_normal((B, C, S)) * 0.1).astype(np.float32)

    want = np.asarray(wpe_process(jnp.asarray(x), cfg))
    for n_dp, n_fb in [(2, 4), (4, 2)]:
        mesh = make_mesh(n_dp, n_fb)
        run = make_sharded_wpe(mesh, cfg)
        got = np.asarray(run(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5, err_msg=f"mesh {n_dp}x{n_fb}")


def test_sharded_subband_gsc_matches_single_device():
    """McSpp covariances + BM/AIC subband-LMS weights shard over (dp, fb)."""
    from distantspeech_tpu.beamform.subband_gsc import SubbandGscConfig, subband_gsc_process
    from distantspeech_tpu.parallel import make_sharded_subband_gsc

    geom = ArrayGeometry.circular(4, 0.032)
    cfg = SubbandGscConfig(n_mics=4, frame_len=128)
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((4, 4, 128 * 6)) * 0.1).astype(np.float32)
    angle = (197.0 / 180.0 * np.pi, 0.0)

    want = np.asarray(subband_gsc_process(jnp.asarray(x), geom, angle, cfg)[0])
    mesh = make_mesh(2, 4)
    run = make_sharded_subband_gsc(mesh, geom, angle, cfg)
    got = np.asarray(run(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_fused_vs_sharded_fused_direct(interpreted_kernel):
    """DIRECT parity between the single-device kernel path and the sharded
    kernel runner on identical input: the same per-lane arithmetic must
    agree to float32 rounding, not merely transitively through enhance_scan
    at looser tolerances.  Swept over the production-guard configs
    (rel_diag) and the VAD gate threshold."""
    from distantspeech_tpu.beamform.mvdr import MvdrConfig
    from distantspeech_tpu.parallel import make_sharded_enhance_pallas

    geom = ArrayGeometry.linear(4, 0.032)
    rng = np.random.default_rng(11)
    B, M, S = 4, 4, 128 * 16
    t = np.arange(S) / 16000
    env = (np.sin(2 * np.pi * 1.7 * t) > 0).astype(np.float32)
    x = (0.3 * rng.standard_normal((B, M, S)) + env * rng.standard_normal(S)).astype(np.float32)

    for rel_diag, p_vad in [(0.0, 0.4), (1e-3, 0.4), (0.0, 0.8)]:
        cfg = EnhanceConfig(mvdr=MvdrConfig(mcra_L=15, rel_diag=rel_diag, p_vad=p_vad))
        a = np.asarray(enhance_process(jnp.asarray(x), geom, (90.0, 0.0), cfg, backend="pallas"))
        run = make_sharded_enhance_pallas(make_mesh(2, 4), geom, (90.0, 0.0), cfg)
        c = np.asarray(run(jnp.asarray(x)))
        scale = np.max(np.abs(a))
        np.testing.assert_allclose(c, a, atol=2e-5 * scale, err_msg=f"sharded cfg {rel_diag},{p_vad}")


def test_sharded_pallas_enhance_matches_single_device(interpreted_kernel):
    """shard_map + the kernel (interpret mode on the CPU mesh):
    per-device bin shards, GSPMD MCRA pre-scan, padded-bin handling."""
    from distantspeech_tpu.parallel import make_sharded_enhance_pallas

    geom = ArrayGeometry.linear(4, 0.032)
    cfg = EnhanceConfig()
    rng = np.random.default_rng(3)
    B, M, S = 4, 4, 128 * 16
    x = rng.standard_normal((B, M, S)).astype(np.float32)

    want = np.asarray(enhance_process(jnp.asarray(x), geom, (90.0, 0.0), cfg))
    for n_dp, n_fb in [(2, 4), (4, 2)]:
        mesh = make_mesh(n_dp, n_fb)
        run = make_sharded_enhance_pallas(mesh, geom, (90.0, 0.0), cfg)
        got = np.asarray(run(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4, err_msg=f"mesh {n_dp}x{n_fb}")
