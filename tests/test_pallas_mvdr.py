"""The Triton MVDR + OM-LSA frame-loop kernel, checked on the CPU.

The kernel runs in the Pallas interpreter against the float64
``enhance_scan`` (the plain reference); its Triton lowering is checked by
lowering for CUDA without a card; the wrapper's padding, shape errors and
refusal to run without a GPU are checked directly.  Small shapes (n_fft 64,
T ~ 40 frames) keep the interpreter fast.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from distantspeech_tpu.beamform.enhance import (
    EnhanceConfig, enhance_init, enhance_process, enhance_scan, enhance_scan_pallas,
)
from distantspeech_tpu.beamform.mvdr import MvdrConfig
from distantspeech_tpu.noise.mcra import mcra_run
from distantspeech_tpu.ops import pallas_mvdr
from distantspeech_tpu.ops.pallas_mvdr import pallas_mvdr_omlsa
from distantspeech_tpu.transform import StftConfig

STFT = StftConfig(64, 32)


def _cfg(rel_diag=0.0, vad_guard=False, mcra_L=15, diag=1e-6):
    return EnhanceConfig(mvdr=MvdrConfig(
        stft=STFT, mcra_L=mcra_L, diag=diag, rel_diag=rel_diag, vad_guard=vad_guard))


def _scene(T, B, M, seed):
    """Spectra with a bursty coherent target over diffuse noise (so the MCRA
    gate opens and closes), plus random-phase steering."""
    rng = np.random.default_rng(seed)
    F = STFT.half_bin
    noise = rng.standard_normal((T, B, F, M)) + 1j * rng.standard_normal((T, B, F, M))
    steer = np.exp(1j * rng.uniform(0, 2 * np.pi, (F, M)))
    burst = (np.arange(T) % 16 >= 8)[:, None, None] * 6.0
    src = (rng.standard_normal((T, B, F)) + 1j * rng.standard_normal((T, B, F))) * burst
    return 0.3 * noise + src[..., None] * steer, steer


def _reference(cfg, Z, steer):
    state = enhance_init(cfg, Z.shape[-1], batch_shape=Z.shape[1:2], cdtype=jnp.complex128)
    _, Y = enhance_scan(cfg, jnp.asarray(steer), state, jnp.asarray(Z, jnp.complex128))
    return np.asarray(Y)


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("vad_guard", [False, True], ids=["guard_off", "guard_on"])
@pytest.mark.parametrize("diag,rel_diag", [(1e-3, 0.0), (1e-6, 1e-3)], ids=["abs_load", "rel_load"])
@pytest.mark.parametrize("M", [2, 4, 8])
def test_kernel_matches_float64_scan(M, diag, rel_diag, vad_guard):
    """The whole fast path (XLA MCRA pre-scan + interpreted kernel) against
    the float64 scan, across array sizes, both loading rules and the VAD
    guard.  The loading keeps Rvv + load I well conditioned: with a few
    gated updates of 8 mics and load 1e-6 the float32 solve alone loses
    ~1e-2 against float64, in the kernel and the complex64 scan alike."""
    cfg = _cfg(diag=diag, rel_diag=rel_diag, vad_guard=vad_guard)
    Z, steer = _scene(40, 2, M, seed=M)
    want = _reference(cfg, Z, steer)
    got = np.asarray(enhance_scan_pallas(cfg, jnp.asarray(steer), jnp.asarray(Z), interpret=True))
    assert got.dtype == np.complex128 and got.shape == want.shape
    # float32 kernel vs float64 reference: f32 roundoff, amplified by the
    # conditioning of Rvv + load I (alpha_v = 0.9998 keeps it rank-poor)
    assert _rel(got, want) < 1e-3


def test_enhance_pallas_rel_diag_matches_scan():
    """rel_diag (the complex64 production guard) is honoured by the kernel,
    not silently dropped: a large value moves the output far outside the
    tolerance, and the kernel still follows the scan."""
    Z, steer = _scene(40, 2, 4, seed=3)
    cfg = _cfg(rel_diag=0.05)
    want = _reference(cfg, Z, steer)
    got = np.asarray(enhance_scan_pallas(cfg, jnp.asarray(steer), jnp.asarray(Z), interpret=True))
    assert _rel(got, want) < 1e-3
    got0 = np.asarray(enhance_scan_pallas(_cfg(), jnp.asarray(steer), jnp.asarray(Z), interpret=True))
    assert _rel(got0, got) > 1e-2


@pytest.mark.parametrize("T", [1, 37])
def test_pallas_mvdr_t_chunking(T):
    """Any frame count: one frame, and an odd count (no frame padding)."""
    cfg = _cfg()
    Z, steer = _scene(T, 3, 4, seed=T)
    want = _reference(cfg, Z, steer)
    got = np.asarray(enhance_scan_pallas(cfg, jnp.asarray(steer), jnp.asarray(Z), interpret=True))
    assert got.shape == (T, 3, STFT.half_bin)
    assert _rel(got, want) < 1e-3


def _planes(T, B, M, seed):
    Z, steer = _scene(T, B, M, seed)
    cfg = _cfg()
    Zc = jnp.asarray(Z, jnp.complex64)
    power = jnp.real(Zc[..., 0] * jnp.conj(Zc[..., 0]))
    lam, p = mcra_run(cfg.mvdr.mcra, power)
    gate = (p < cfg.mvdr.p_vad).astype(jnp.float32)
    return Zc, gate, jnp.asarray(steer, jnp.complex64), p, lam


@pytest.mark.parametrize("T,B", [(24, 1), (24, 3), (8, 32)])
def test_pallas_mvdr_matches_scan(T, B):
    """Lane padding: B*F = B*33 lanes pad to a multiple of BLOCK_LANES (33
    and 99 lanes pad; 32*33 do not).  Padded lanes never reach the real
    ones: the last utterance gives the same bits at its place in the batch
    as alone, and the batch follows the float64 scan."""
    Z, gate, steer, p, lam = _planes(T, B, 4, seed=5)
    got = np.asarray(pallas_mvdr_omlsa(Z, gate, steer, p, lam, interpret=True))
    last = np.asarray(pallas_mvdr_omlsa(
        Z[:, -1:], gate[:, -1:], steer, p[:, -1:], lam[:, -1:], interpret=True))
    np.testing.assert_array_equal(got[:, -1:], last)
    assert np.isfinite(got).all() and got.dtype == np.complex64
    assert _rel(got, _reference(_cfg(), np.asarray(Z), np.asarray(steer))) < 1e-3


def test_enhance_pallas_backend_matches_scan(interpreted_kernel):
    """The user entry point: enhance_process(backend='pallas') on a
    time-domain batch against backend='scan'."""
    from distantspeech_tpu.array.geometry import ArrayGeometry

    geom = ArrayGeometry.linear(4, 0.032)
    cfg = _cfg(mcra_L=8)
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((2, 4, 32 * 40)))
    want = np.asarray(enhance_process(x, geom, (90.0, 0.0), cfg))
    got = np.asarray(enhance_process(x, geom, (90.0, 0.0), cfg, backend="pallas"))
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-3


def _bad_calls():
    Z = jnp.zeros((4, 2, 5, 3), jnp.complex64)
    g = jnp.ones((4, 2, 5), jnp.float32)
    a = jnp.ones((5, 3), jnp.complex64)
    return {
        "Z_3d": ((Z[:, 0], g, a, g, g), {}, "4-D"),
        "gate_shape": ((Z, g[:, :1], a, g, g), {}, "gate must be"),
        "lam_shape": ((Z, g, a, g, g[:3]), {}, "lam must be"),
        "steer_shape": ((Z, g, a[:, :2], g, g), {}, "steer must be"),
        "p_shape": ((Z, g, a, g[..., :2], g), {}, "p must be"),
    }


@pytest.mark.parametrize("case", list(_bad_calls()))
def test_pallas_mvdr_api_validation(case):
    args, kwargs, match = _bad_calls()[case]
    with pytest.raises(ValueError, match=match):
        pallas_mvdr_omlsa(*args, interpret=True, **kwargs)


def test_enhance_scan_pallas_needs_4d():
    a = jnp.ones((5, 3), jnp.complex64)
    with pytest.raises(ValueError, match="T, B, F, M"):
        enhance_scan_pallas(EnhanceConfig(), a, jnp.zeros((4, 5, 3), jnp.complex64), interpret=True)


def test_pallas_backend_without_gpu_raises():
    """Without a card the kernel path refuses to run; it never falls back to
    the interpreter on its own."""
    from distantspeech_tpu.array.geometry import ArrayGeometry

    assert jax.default_backend() == "cpu"
    x = jnp.zeros((1, 4, 32 * 8))
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        enhance_process(x, ArrayGeometry.linear(4, 0.032), (90.0, 0.0), _cfg(), backend="pallas")
    Z, gate, steer, p, lam = _planes(4, 1, 4, seed=0)
    with pytest.raises(RuntimeError, match="interpret=True"):
        pallas_mvdr_omlsa(Z, gate, steer, p, lam)


@pytest.mark.parametrize("backend", ["fused", "mega", "triton"])
def test_enhance_process_rejects_unknown_backend(backend):
    from distantspeech_tpu.array.geometry import ArrayGeometry

    with pytest.raises(ValueError, match="backend must be"):
        enhance_process(jnp.zeros((1, 4, 256)), ArrayGeometry.linear(4, 0.032), backend=backend)


@pytest.mark.parametrize("T,B,F,M", [(500, 64, 129, 8), (500, 1, 129, 8), (40, 3, 33, 4)],
                         ids=["flagship", "one_stream", "small"])
def test_kernel_lowers_through_triton(monkeypatch, T, B, F, M):
    """The kernel lowers for CUDA through the Triton route (the flagship
    width, 8 mics, F = 129, T = 500, B = 64, among others): one Triton
    custom call under the kernel's stable name, one warp per 32 lanes,
    a grid over the padded lane blocks, nothing interpreted."""
    monkeypatch.setattr(pallas_mvdr.jax, "default_backend", lambda: "gpu")
    z = jax.ShapeDtypeStruct((T, B, F, M), jnp.complex64)
    tf = jax.ShapeDtypeStruct((T, B, F), jnp.float32)
    st = jax.ShapeDtypeStruct((F, M), jnp.complex64)
    fn = jax.jit(lambda Z, g, s, p, l: pallas_mvdr_omlsa(Z, g, s, p, l, rel_diag=1e-5))
    text = fn.trace(z, tf, st, tf, tf).lower(lowering_platforms=("cuda",)).as_text()
    assert text.count("__gpu$xla.gpu.triton") == 1
    assert pallas_mvdr.KERNEL_NAME in text
    assert pallas_mvdr.NUM_WARPS * 32 == pallas_mvdr.BLOCK_LANES
    assert f"num_warps = {pallas_mvdr.NUM_WARPS}" in text
    assert f"grid_x = {-(-B * F // pallas_mvdr.BLOCK_LANES)}" in text


@pytest.mark.chip
def test_kernel_on_card_matches_scan(gpu):
    """On the card: the Triton-compiled kernel (no interpreter) against the
    scan at the benched config, guard off, 8 mics."""
    from distantspeech_tpu.array.geometry import ArrayGeometry

    geom = ArrayGeometry.linear(8, 0.032)
    cfg = EnhanceConfig(mvdr=MvdrConfig(mcra_L=65, rel_diag=1e-5))
    x = jnp.asarray(np.random.default_rng(0).standard_normal((4, 8, 16000)), jnp.float32)
    want = np.asarray(enhance_process(x, geom, (90.0, 0.0), cfg))
    got = np.asarray(enhance_process(x, geom, (90.0, 0.0), cfg, backend="pallas"))
    assert _rel(got, want) < 1e-4
