"""Structural invariants of the scan pipelines (the plain references).

Utterances in a batch never interact: a batched run equals each row run
alone.  A chunked run that carries the state between chunks equals the
offline run over the whole signal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from distantspeech_tpu.array.geometry import ArrayGeometry

ANG = (197.0 / 180.0 * np.pi, 0.0)


def _aec_offline(x, far, cfg):
    """Offline AEC: scan ``aec_step`` over blocks.  x: [..., S] mic."""
    from distantspeech_tpu.adaptive.aec import aec_init, aec_step

    L = cfg.block_len
    T = x.shape[-1] // L
    blocks = lambda s: jnp.moveaxis(s[..., : T * L].reshape(*s.shape[:-1], T, L), -2, 0)
    state = aec_init(cfg, batch_shape=x.shape[:-1], dtype=x.dtype)
    _, (out, _) = jax.lax.scan(lambda st, b: aec_step(cfg, st, b[0], b[1]), state, (blocks(far), blocks(x)))
    return jnp.moveaxis(out, 0, -2).reshape(*x.shape[:-1], T * L)


def _pipelines():
    from distantspeech_tpu.adaptive.aec import AecConfig
    from distantspeech_tpu.beamform import (
        FdGscConfig, SubbandGscConfig, TdGscConfig, fdgsc_process, subband_gsc_process, tdgsc_process,
    )
    from distantspeech_tpu.beamform.enhance import enhance_process
    from distantspeech_tpu.doa.srp import srp_process
    from distantspeech_tpu.kws import DualMicKwsConfig, kws_process
    from distantspeech_tpu.runtime.full_stack import FullStackConfig, full_stack_process

    g4 = ArrayGeometry.circular(4, 0.032)
    fs_cfg = FullStackConfig(n_mics=4, frame_len=256, aec=AecConfig(filter_len=512, num_block=2))
    return {
        # name: (fn(x [..., M, S], far [..., S]) -> output, M, S)
        "tdgsc": (lambda x, f: tdgsc_process(x, g4, ANG, TdGscConfig(n_mics=4))[0], 4, 256 * 6),
        "fdgsc": (lambda x, f: fdgsc_process(x, g4, ANG, FdGscConfig(n_mics=4))[0], 4, 256 * 6),
        "subband_gsc": (lambda x, f: subband_gsc_process(
            x, g4, ANG, SubbandGscConfig(n_mics=4, frame_len=128))[0], 4, 128 * 6),
        "kws": (lambda x, f: kws_process(x, DualMicKwsConfig(frame_len=128)), 2, 128 * 8),
        "aec": (lambda x, f: _aec_offline(x[..., 0, :], f, AecConfig(filter_len=128, num_block=2)), 1, 64 * 12),
        "full_stack": (lambda x, f: full_stack_process(x, f, g4, ANG, fs_cfg)[0], 4, 256 * 6),
        "enhance": (lambda x, f: enhance_process(x, ArrayGeometry.linear(4, 0.032)), 4, 128 * 12),
        "srp": (lambda x, f: srp_process(x, ArrayGeometry.linear(4, 0.032))[0], 4, 128 * 6),
    }


@pytest.mark.parametrize("name", list(_pipelines()))
def test_batch_rows_independent(name):
    fn, M, S = _pipelines()[name]
    rng = np.random.default_rng(len(name))
    x = jnp.asarray(rng.standard_normal((3, M, S)) * 0.2)
    far = jnp.asarray(rng.standard_normal((3, S)) * 0.2)
    batched = np.asarray(fn(x, far))
    assert batched.shape[0] == 3 and np.isfinite(batched).all()
    for b in range(3):
        solo = np.asarray(fn(x[b], far[b]))
        np.testing.assert_allclose(batched[b], solo, rtol=1e-10, atol=1e-12, err_msg=f"row {b}")


def _kws_chunked(x, cfg, blocks_per_chunk):
    from distantspeech_tpu.kws import kws_init, kws_step

    L = cfg.frame_len
    step = jax.jit(lambda st, c: jax.lax.scan(lambda s, b: kws_step(cfg, s, b[0], b[1]), st, c))
    state = kws_init(cfg, dtype=x.dtype)
    outs = []
    for i in range(0, x.shape[-1] // L, blocks_per_chunk):
        chunk = x[:, i * L:(i + blocks_per_chunk) * L]
        state, out = step(state, jnp.moveaxis(chunk.reshape(2, -1, L), 1, 0))
        outs.append(np.asarray(out).reshape(-1))
    return np.concatenate(outs)


def _aec_chunked(x, far, cfg, blocks_per_chunk):
    from distantspeech_tpu.adaptive.aec import aec_init, aec_step

    L = cfg.block_len
    step = jax.jit(lambda st, f, d: jax.lax.scan(lambda s, b: aec_step(cfg, s, b[0], b[1]), st, (f, d)))
    state = aec_init(cfg, dtype=x.dtype)
    outs = []
    for i in range(0, x.shape[-1] // L, blocks_per_chunk):
        sl = slice(i * L, (i + blocks_per_chunk) * L)
        state, (out, _) = step(state, far[sl].reshape(-1, L), x[sl].reshape(-1, L))
        outs.append(np.asarray(out).reshape(-1))
    return np.concatenate(outs)


@pytest.mark.parametrize("name", ["kws", "aec"])
def test_chunked_equals_offline(name):
    """The per-chunk step carrying its state (what a live stream runs)
    reproduces the offline pipeline exactly."""
    from distantspeech_tpu.adaptive.aec import AecConfig
    from distantspeech_tpu.kws import DualMicKwsConfig, kws_process

    rng = np.random.default_rng(21)
    if name == "kws":
        cfg = DualMicKwsConfig(frame_len=128)
        x = jnp.asarray(rng.standard_normal((2, 128 * 12)) * 0.2)
        want = np.asarray(kws_process(x, cfg))
        got = _kws_chunked(x, cfg, blocks_per_chunk=4)
    else:
        cfg = AecConfig(filter_len=128, num_block=2)
        far = jnp.asarray(rng.standard_normal(64 * 12))
        x = jnp.asarray(np.convolve(np.asarray(far), rng.standard_normal(32))[: 64 * 12]
                        + 0.05 * rng.standard_normal(64 * 12))
        want = np.asarray(_aec_offline(x, far, cfg))
        got = _aec_chunked(x, far, cfg, blocks_per_chunk=3)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
