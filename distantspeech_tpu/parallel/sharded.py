"""Sharded flagship pipeline: utterance DP x frequency-bin model parallel.

The scaling recipe (SURVEY §2, §5): annotate the shardings of the batch and
of the per-bin state, and let XLA insert the collectives — the MCRA
frequency smoothing becomes a 1-bin halo exchange (a collective-permute),
the scalar frame counters replicate, and everything else is local to
its bin shard.  No hand-written NCCL-style communication, by design.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from distantspeech_tpu.array.geometry import ArrayGeometry
from distantspeech_tpu.array.steering import steering_vector
from distantspeech_tpu.beamform.enhance import EnhanceConfig, enhance_init, enhance_scan
from distantspeech_tpu.transform import analysis, synthesis


def enhance_process_sharded(
    x: jnp.ndarray,
    steer: jnp.ndarray,
    mesh: Mesh,
    cfg: EnhanceConfig,
    n_mics: int,
) -> jnp.ndarray:
    """MVDR+OM-LSA of a batch with explicit dp/fb sharding constraints.

    x: [B, M, S]; steer: [F, M].  Trace under jit with this mesh's devices.
    """
    spec_tf = NamedSharding(mesh, P(None, "dp", "fb", None))  # [T, B, F, M]

    X = analysis(x, cfg.stft)  # [B, M, T, F]
    Zt = jnp.moveaxis(jnp.moveaxis(X, -3, -1), -3, 0)  # [T, B, F, M]
    Zt = jax.lax.with_sharding_constraint(Zt, spec_tf)

    state = enhance_init(cfg, n_mics, batch_shape=Zt.shape[1:-2], cdtype=Zt.dtype)
    # per-bin state shards over fb; scalar counters replicate
    state = jax.tree.map(
        lambda leaf: jax.lax.with_sharding_constraint(
            leaf,
            NamedSharding(
                mesh,
                P("dp", "fb", *([None] * (leaf.ndim - 2))) if leaf.ndim >= 2 else P(),
            ),
        ),
        state,
    )
    _, Y = enhance_scan(cfg, steer.astype(Zt.dtype), state, Zt)  # [T, B, F]
    Y = jax.lax.with_sharding_constraint(Y, NamedSharding(mesh, P(None, "dp", "fb")))
    return synthesis(jnp.moveaxis(Y, 0, -2), cfg.stft)


def make_sharded_enhance(
    mesh: Mesh,
    geometry: ArrayGeometry,
    look_angle_deg=(90.0, 0.0),
    cfg: EnhanceConfig = EnhanceConfig(),
):
    """Jit the sharded flagship pipeline for a mesh.

    Returns f(x [B, M, S]) -> [B, S] with B divisible by the dp axis.
    """
    angle_rad = np.asarray(look_angle_deg, dtype=np.float64) / 180.0 * np.pi
    steer = np.asarray(steering_vector(geometry, angle_rad, cfg.stft.n_fft), dtype=np.complex64)
    in_sharding = NamedSharding(mesh, P("dp", None, None))

    @jax.jit
    def run(x):
        x = jax.lax.with_sharding_constraint(x, in_sharding)
        return enhance_process_sharded(x, steer, mesh, cfg, geometry.n_mics)

    return run


def make_sharded_enhance_pallas(
    mesh: Mesh,
    geometry: ArrayGeometry,
    look_angle_deg=(90.0, 0.0),
    cfg: EnhanceConfig = EnhanceConfig(),
):
    """The flagship fast path over a ('dp','fb') mesh via shard_map.

    The MCRA pre-scan runs under GSPMD (its 1-bin frequency-smoothing halo
    is XLA-inserted); the MVDR+OM-LSA kernel (``ops.pallas_mvdr``) then runs
    per device on its local (batch-shard x bin-shard) block under
    ``shard_map`` — the kernel is purely per-bin, so the shard region needs
    no collectives at all.  Bins pad up to a multiple of the fb axis (padded
    bins carry gate=0/steer=1 and are dropped before synthesis).

    Returns f(x [B, M, S]) -> [B, S]; B divisible by dp.  The kernel needs
    CUDA GPUs.
    """
    from distantspeech_tpu.noise.mcra import mcra_run
    from distantspeech_tpu.ops.pallas_mvdr import pallas_mvdr_omlsa

    n_fb = mesh.shape["fb"]
    mv = cfg.mvdr
    F = cfg.stft.half_bin
    Fp = int(np.ceil(F / n_fb) * n_fb)
    angle_rad = np.asarray(look_angle_deg, dtype=np.float64) / 180.0 * np.pi
    steer = np.ones((Fp, geometry.n_mics), dtype=np.complex64)
    steer[:F] = steering_vector(geometry, angle_rad, cfg.stft.n_fft)

    in_sharding = NamedSharding(mesh, P("dp", None, None))
    spec_z = P(None, "dp", "fb", None)
    spec_tf = P(None, "dp", "fb")
    spec_a = P("fb", None)

    def _local(Z, gate, a, p, lam):
        return pallas_mvdr_omlsa(
            Z, gate, a, p, lam, alpha_v=mv.alpha_v, diag=mv.diag, rel_diag=mv.rel_diag,
            alpha_xi=cfg.alpha_xi, gmin=cfg.gmin,
        )

    local_kernel = jax.shard_map(
        _local,
        mesh=mesh,
        in_specs=(spec_z, spec_tf, spec_a, spec_tf, spec_tf),
        out_specs=spec_tf,
        check_vma=False,  # pallas_call out_shapes don't carry vma metadata
    )

    @jax.jit
    def run(x):
        x = jax.lax.with_sharding_constraint(x, in_sharding)
        X = analysis(x, cfg.stft)  # [B, M, T, F]
        Zt = jnp.moveaxis(jnp.moveaxis(X, -3, -1), -3, 0)  # [T, B, F, M]
        Zt = jnp.pad(Zt, [(0, 0), (0, 0), (0, Fp - F), (0, 0)])
        Zt = jax.lax.with_sharding_constraint(Zt, NamedSharding(mesh, spec_z))

        power = jnp.real(Zt[..., 0] * jnp.conj(Zt[..., 0]))[..., :F]
        lam, p, sr = mcra_run(mv.mcra, power, return_sr=True)  # GSPMD handles the 1-bin halo
        gate = p < mv.p_vad
        if mv.vad_guard:
            gate = gate & (sr <= mv.mcra.delta_s)
        gate = gate.astype(jnp.float32)
        padF = [(0, 0), (0, 0), (0, Fp - F)]
        gate = jnp.pad(gate, padF)
        p = jnp.pad(p, padF)
        lam = jnp.pad(lam, padF, constant_values=1.0)

        Y = local_kernel(Zt, gate, jnp.asarray(steer), p, lam)  # [T, B, Fp]
        Y = jax.lax.with_sharding_constraint(Y, NamedSharding(mesh, spec_tf))
        return synthesis(jnp.moveaxis(Y[..., :F], 0, -2), cfg.stft)

    return run


def _constrain_state(mesh: Mesh, state, f_axis: int = 1):
    """Shard a per-bin state pytree over ('dp', 'fb').

    Leaves are [B, ..., F, ...] with the frequency axis at ``f_axis``;
    leaves with fewer than ``f_axis + 1`` dims (scalar frame counters,
    batch-only stats) replicate beyond the batch axis.
    """

    def spec(leaf):
        if leaf.ndim > f_axis:
            axes = ["dp"] + [None] * (f_axis - 1) + ["fb"] + [None] * (leaf.ndim - f_axis - 1)
            return P(*axes)
        if leaf.ndim >= 1:
            return P("dp", *([None] * (leaf.ndim - 1)))
        return P()

    return jax.tree.map(
        lambda leaf: jax.lax.with_sharding_constraint(leaf, NamedSharding(mesh, spec(leaf))),
        state,
    )


def make_sharded_wpe(mesh: Mesh, cfg=None):
    """Jit subband RLS-WPE dereverberation over a ('dp', 'fb') mesh.

    The [B, F, C*N, C*N] inverse-correlation recursion P (derev/wpe.py,
    oracle awpe.py:172-183) is the state-heaviest carry in the codebase and
    the cleanest bin-shard showcase: every frame's RLS update is purely
    per-bin, so the whole scan body is collective-free — only the subband
    analysis/synthesis at the edges redistribute.  Returns
    f(x [B, C, S]) -> [B, S] with B divisible by the dp axis.
    """
    from distantspeech_tpu.derev.wpe import WpeConfig, wpe_run
    from distantspeech_tpu.transform.subband import subband_analysis, subband_synthesis

    if cfg is None:
        cfg = WpeConfig()
    in_sharding = NamedSharding(mesh, P("dp", None, None))
    spec_tfc = NamedSharding(mesh, P(None, "dp", "fb", None))  # [T, B, F, C]

    @jax.jit
    def run(x):
        x = jax.lax.with_sharding_constraint(x, in_sharding)
        Y = subband_analysis(x, cfg.subband)  # [B, C, T, F]
        D_tf = jnp.moveaxis(jnp.moveaxis(Y, -3, -1), -3, 0)  # [T, B, F, C]
        D_tf = jax.lax.with_sharding_constraint(D_tf, spec_tfc)
        # W/buf/P/var are all [B, F, ...]: pin (dp, fb) on every scan carry
        e = wpe_run(cfg, D_tf, constrain=lambda s: _constrain_state(mesh, s))
        e0 = jnp.moveaxis(e[..., 0], 0, -2)  # [B, T, F]
        e0 = jax.lax.with_sharding_constraint(e0, NamedSharding(mesh, P("dp", None, "fb")))
        return subband_synthesis(e0, cfg.subband)

    return run


def make_sharded_subband_gsc(
    mesh: Mesh, geometry: ArrayGeometry, angle_rad=(197.0 / 180.0 * np.pi, 0.0), cfg=None
):
    """Jit the SubbandGSC over a ('dp', 'fb') mesh.

    The McSpp [B, F, C, C] covariances and the BM/AIC subband-LMS weights
    shard over (dp, fb); the per-block STFT round-trips of the subband AFs
    redistribute between the time and bin layouts (XLA-inserted
    all-to-alls), matching the reference's SubbandAF time-domain dispatch
    (SubbandGSC.py:170-263).  Returns f(x [B, M, S]) -> [B, S].
    """
    from distantspeech_tpu.adaptive.feature import dc_notch, dc_notch_init
    from distantspeech_tpu.array.alignment import time_alignment_filters
    from distantspeech_tpu.beamform.subband_gsc import (
        SubbandGscConfig, SubbandGscState, subband_gsc_init, subband_gsc_step,
    )
    from distantspeech_tpu.ops.fir import fir_filter_offline

    if cfg is None:
        cfg = SubbandGscConfig(n_mics=geometry.n_mics)
    L = cfg.frame_len
    coeffs = np.asarray(time_alignment_filters(geometry, angle_rad), dtype=np.float32)
    in_sharding = NamedSharding(mesh, P("dp", None, None))

    def constrain(state: SubbandGscState) -> SubbandGscState:
        dp = lambda leaf: jax.lax.with_sharding_constraint(
            leaf, NamedSharding(mesh, P("dp", *([None] * (leaf.ndim - 1))))
        )
        core = state.core
        core = core._replace(
            spp=_constrain_state(mesh, core.spp, f_axis=1),
            bm=_constrain_state(mesh, core.bm, f_axis=2),  # leading mic axis
            istft_bm=dp(core.istft_bm),
            aic=_constrain_state(mesh, core.aic, f_axis=1),
            stft_aic_x=dp(core.stft_aic_x),
            istft_aic=dp(core.istft_aic),
        )
        return SubbandGscState(
            stft_al=dp(state.stft_al),
            stft_fbf=dp(state.stft_fbf),
            delay_fbf=dp(state.delay_fbf),
            stft_fbf_d=dp(state.stft_fbf_d),
            core=core,
        )

    @jax.jit
    def run(x):
        x = jax.lax.with_sharding_constraint(x, in_sharding)
        _, xn = dc_notch(dc_notch_init(x.shape[:-1], dtype=x.dtype), x, radius=0.98)
        aligned = fir_filter_offline(xn, jnp.asarray(coeffs))
        T = x.shape[-1] // L
        ab = jnp.moveaxis(aligned[..., : T * L].reshape(*x.shape[:-1], T, L), -2, 0)
        Fn = jnp.asarray(cfg.spp.mccdr.fn_pair(), dtype=x.dtype)

        state = constrain(subband_gsc_init(cfg, batch_shape=x.shape[:-2], dtype=x.dtype))

        def body(s, blk):
            s, (out, _, _) = subband_gsc_step(cfg, Fn, s, blk)
            return constrain(s), out

        _, out = jax.lax.scan(body, state, ab)
        return jnp.moveaxis(out, 0, -2).reshape(*x.shape[:-2], T * L)

    return run


def make_sharded_gsc(mesh: Mesh, geometry: ArrayGeometry, angle_rad=(197.0 / 180.0 * np.pi, 0.0), cfg=None):
    """Jit the frequency-domain GSC over a ('dp','fb') mesh.

    Demonstrates the same recipe on a second pipeline: the MC-MCRA SPP state
    ([B, F, C, C] covariances and [B, F] statistics) shards over (dp, fb);
    its 3-tap frequency smoothing becomes the halo exchange.
    Returns f(x [B, M, S]) -> [B, S].
    """
    from distantspeech_tpu.beamform.gsc import GscConfig, gsc_init, gsc_step, gsc_steering

    if cfg is None:
        cfg = GscConfig(n_mics=geometry.n_mics)
    a = np.asarray(gsc_steering(cfg, geometry, angle_rad), dtype=np.complex64)
    in_sharding = NamedSharding(mesh, P("dp", None, None))
    spec_tf = NamedSharding(mesh, P(None, "dp", "fb", None))

    @jax.jit
    def run(x):
        x = jax.lax.with_sharding_constraint(x, in_sharding)
        X = analysis(x, cfg.stft)  # [B, M, T, F]
        Zt = jnp.moveaxis(jnp.moveaxis(X, -3, -1), -3, 0)  # [T, B, F, M]
        Zt = jax.lax.with_sharding_constraint(Zt, spec_tf)
        state = gsc_init(cfg, batch_shape=Zt.shape[1:-2], cdtype=Zt.dtype)
        state = jax.tree.map(
            lambda leaf: jax.lax.with_sharding_constraint(
                leaf,
                NamedSharding(
                    mesh,
                    P("dp", "fb", *([None] * (leaf.ndim - 2))) if leaf.ndim >= 2 else P(),
                ),
            ),
            state,
        )
        _, Y = jax.lax.scan(lambda s, z: gsc_step(cfg, jnp.asarray(a).astype(z.dtype), s, z), state, Zt)
        Y = jax.lax.with_sharding_constraint(Y, NamedSharding(mesh, P(None, "dp", "fb")))
        return synthesis(jnp.moveaxis(Y, 0, -2), cfg.stft)

    return run
