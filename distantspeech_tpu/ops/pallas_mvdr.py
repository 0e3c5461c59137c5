"""Pallas (Triton route) kernel: the flagship MVDR + OM-LSA frame recursion.

The flagship's hot loop is a ``lax.scan`` over ~500 frames whose carry (the
per-bin [B, F, M, M] noise covariance) goes through device memory on every
frame, and each frame is several small fused launches (``enhance_scan``).
The work per lane is tiny (about 1 kFLOP per (utterance, bin) per frame),
so that loop is launch- and latency-bound, far from either roofline.

This kernel runs the WHOLE frame loop inside one ``pallas_call``:

- the grid runs over blocks of the flattened (utterance x bin) lane axis
  only; blocks are independent (no sequential grid axis, nothing carried
  between blocks);
- inside a block a ``lax.fori_loop`` walks the frames; the covariance's
  lower triangle, the held solve vector u and the OM-LSA carries
  (G_H1, gamma) are loop carries, i.e. registers — device memory is read
  once per frame for the spectra and written once for the output;
- inputs are laid out ``[T, M, lanes]`` so each frame's loads coalesce.

Split-complex throughout.  The MCRA speech-presence track (cross-bin
smoothing) stays an XLA pre-scan (``beamform.enhance.enhance_scan_pallas``)
and comes in as per-frame gate / p / lambda_d planes.

Semantics are ``enhance_step`` without MCRA (``tests/test_pallas_mvdr.py``
checks the kernel in interpret mode against the float64 scan).  Oracle for
the recursion: DistantSpeech/beamformer/adaptivebeamformer.py:86-105.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

KERNEL_NAME = "mvdr_omlsa_frame_loop"

# One lane per thread: at M = 8 a lane keeps ~200 live float32 values (82
# carries plus the LDL temporaries), which fits the register file only at
# one lane per thread.  The frame chain is latency-bound, so the block size
# barely matters (32, 64 and 128 lanes were within 2% end to end on an
# H100); 32 pads least (the flagship's 64 x 129 lanes need no padding).
BLOCK_LANES = 32
NUM_WARPS = BLOCK_LANES // 32


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _mvdr_update_ldl(zr, zi, upd, ar, ai, Rr, Ri, Ur, Ui, M, alpha_v, diag, rel_diag=0.0):
    """Gated hermitian rank-1 update of the lower triangle of R, then
    u = (R + load I)^-1 a via an unrolled LDL^H factorisation and two
    triangular solves — O(M^3/6) complex muls and no sqrt, versus O(M^3)
    for a full Gauss-Jordan inverse, and only the M-vector u (not the
    M x M inverse) is carried for gate-off frames (held in Ur/Ui).

    load = diag + rel_diag * tr(R)/M, matching ``MvdrConfig.rel_diag``
    (the complex64 production guard; beamform/mvdr.py:96-100).

    Route-neutral elementwise code: every operand is one lane vector.
    zr/zi, ar/ai: per-mic sequences of lanes; upd: bool lanes (the
    covariance-update gate) or None for unconditional updates; Rr/Ri:
    mappings (i, j) -> lanes for i >= j (Ri only i > j); Ur/Ui: per-mic
    mutable sequences.  Rr, Ri, Ur and Ui are updated in place."""
    beta = 1.0 - alpha_v

    def gated(new, old):
        return new if upd is None else jnp.where(upd, new, old)

    # --- gated hermitian rank-1 update, lower triangle only ----------------
    # (mvdr_step:82-88; R[i][j] for i>j, real diagonal in Rr[j][j])
    for i in range(M):
        for j in range(i + 1):
            if i == j:
                out = zr[i] * zr[i] + zi[i] * zi[i]
                Rr[i, i] = gated(alpha_v * Rr[i, i] + beta * out, Rr[i, i])
            else:
                outr = zr[i] * zr[j] + zi[i] * zi[j]
                outi = zi[i] * zr[j] - zr[i] * zi[j]
                Rr[i, j] = gated(alpha_v * Rr[i, j] + beta * outr, Rr[i, j])
                Ri[i, j] = gated(alpha_v * Ri[i, j] + beta * outi, Ri[i, j])

    load = diag
    if rel_diag:
        tr_R = Rr[0, 0]
        for i in range(1, M):
            tr_R = tr_R + Rr[i, i]
        load = diag + (rel_diag / M) * tr_R  # per-lane loading

    # --- LDL^H of A = R + load I (unit lower L, real diagonal D) -----------
    Lr = [[None] * M for _ in range(M)]
    Li = [[None] * M for _ in range(M)]
    D = [None] * M
    Dinv = [None] * M
    for j in range(M):
        d = Rr[j, j] + load
        for k in range(j):
            d = d - (Lr[j][k] * Lr[j][k] + Li[j][k] * Li[j][k]) * D[k]
        D[j] = d
        Dinv[j] = 1.0 / d
        for i in range(j + 1, M):
            sr, si = Rr[i, j], Ri[i, j]
            for k in range(j):
                # L[i][k] * conj(L[j][k]) * D[k]
                tr, ti = _cmul(Lr[i][k], Li[i][k], Lr[j][k], -Li[j][k])
                sr, si = sr - tr * D[k], si - ti * D[k]
            Lr[i][j] = sr * Dinv[j]
            Li[i][j] = si * Dinv[j]

    # --- solve L v = a (unit diag), v /= D, L^H u = v -----------------------
    vr = [None] * M
    vi = [None] * M
    for i in range(M):
        sr, si = ar[i], ai[i]
        for k in range(i):
            tr, ti = _cmul(Lr[i][k], Li[i][k], vr[k], vi[k])
            sr, si = sr - tr, si - ti
        vr[i], vi[i] = sr, si
    for i in range(M):
        vr[i], vi[i] = vr[i] * Dinv[i], vi[i] * Dinv[i]
    ur = [None] * M
    ui = [None] * M
    for i in range(M - 1, -1, -1):
        sr, si = vr[i], vi[i]
        for k in range(i + 1, M):
            # conj(L[k][i]) * u[k]
            tr, ti = _cmul(Lr[k][i], -Li[k][i], ur[k], ui[k])
            sr, si = sr - tr, si - ti
        ur[i], ui[i] = sr, si

    # --- hold u for gate-off frames (the reference holds Rvv_inv) ----------
    for i in range(M):
        Ur[i] = gated(ur[i], Ur[i])
        Ui[i] = gated(ui[i], Ui[i])


def _mvdr_output(zr, zi, ar, ai, Ur, Ui, M):
    """y = w^H z with w = u / (a^H u) (mvdr_step:90-91), u held in Ur/Ui."""
    den_r, den_i = _cmul(ar[0], -ai[0], Ur[0], Ui[0])  # conj(a) * u
    for r in range(1, M):
        tr, ti = _cmul(ar[r], -ai[r], Ur[r], Ui[r])
        den_r, den_i = den_r + tr, den_i + ti
    # w^H z = conj(u/den)^T z = (u^H z) / conj(den)
    nr, ni = _cmul(Ur[0], -Ui[0], zr[0], zi[0])  # conj(u) * z
    for r in range(1, M):
        tr, ti = _cmul(Ur[r], -Ui[r], zr[r], zi[r])
        nr, ni = nr + tr, ni + ti
    dmag = den_r * den_r + den_i * den_i
    cinv_r, cinv_i = den_r / dmag, den_i / dmag  # 1 / conj(den)
    return _cmul(nr, ni, cinv_r, cinv_i)


def _tri_keys(M):
    """Lower-triangle slots: (i, j) for i >= j (real part) and i > j (imag)."""
    low = [(i, j) for i in range(M) for j in range(i + 1)]
    return low, [(i, j) for (i, j) in low if i > j]


def _mvdr_omlsa_kernel(
    zr_ref, zi_ref, gate_ref, p_ref, lam_ref, ar_ref, ai_ref,  # inputs
    yr_ref, yi_ref,  # outputs
    *, T: int, M: int, alpha_v: float, diag: float, rel_diag: float, alpha_xi: float, gmin: float,
):
    """One block of lanes through all T frames: MVDR beamform + decision-
    directed OM-LSA gain (enhance_step, beamform/enhance.py; oracle
    mcspp_base.py:140-156).  z refs: [T, M, lanes]; gate/p/lam and the
    outputs: [T, lanes]; steering ar/ai: [M, lanes]."""
    low, strict = _tri_keys(M)
    ar = [ar_ref[m, :] for m in range(M)]
    ai = [ai_ref[m, :] for m in range(M)]
    zero = jnp.zeros_like(ar[0])
    one = jnp.ones_like(ar[0])
    log_gmin = float(np.log(gmin))

    def frame(t, carry):
        r_low, i_strict, u_r, u_i, gh, gam = carry
        Rr = dict(zip(low, r_low))
        Ri = dict(zip(strict, i_strict))
        Ur, Ui = list(u_r), list(u_i)
        zr = [zr_ref[t, m, :] for m in range(M)]
        zi = [zi_ref[t, m, :] for m in range(M)]
        upd = gate_ref[t, :] > 0.5
        _mvdr_update_ldl(zr, zi, upd, ar, ai, Rr, Ri, Ur, Ui, M, alpha_v, diag, rel_diag)
        yr, yi = _mvdr_output(zr, zi, ar, ai, Ur, Ui, M)

        p = p_ref[t, :]
        lam = jnp.maximum(lam_ref[t, :], 1e-10)
        gamma = (yr * yr + yi * yi) / lam
        xi = alpha_xi * gh * gh * gam + (1.0 - alpha_xi) * jnp.maximum(gamma - 1.0, 0.0)
        g_h1 = xi / (1.0 + xi)
        # G = clip(G_H1^p * gmin^(1-p), gmin, 1) via exp/log
        log_g = p * jnp.log(jnp.maximum(g_h1, 1e-30)) + (1.0 - p) * log_gmin
        g = jnp.clip(jnp.exp(log_g), gmin, 1.0)
        yr_ref[t, :] = yr * g
        yi_ref[t, :] = yi * g
        return (
            tuple(Rr[k] for k in low), tuple(Ri[k] for k in strict),
            tuple(Ur), tuple(Ui), g_h1, gamma,
        )

    init = (
        (zero,) * len(low), (zero,) * len(strict), (zero,) * M, (zero,) * M, one, one,
    )
    jax.lax.fori_loop(0, T, frame, init)


def pallas_mvdr_omlsa(
    Z: jnp.ndarray, gate: jnp.ndarray, steer: jnp.ndarray, p: jnp.ndarray, lam: jnp.ndarray,
    alpha_v: float = 0.9998, diag: float = 1e-6, rel_diag: float = 0.0,
    alpha_xi: float = 0.92, gmin: float = 0.0631, interpret: bool = False,
) -> jnp.ndarray:
    """Fused MVDR + OM-LSA frame loop.

    Z: [T, B, F, M] complex spectra; gate: [T, B, F] (1 = update the noise
    covariance this frame, the MCRA decision ``p < p_vad``); steer: [F, M]
    complex steering vectors; p, lam: [T, B, F] MCRA speech presence and
    noise PSD.  Returns the postfiltered spectrum Y [T, B, F] in Z's dtype
    (computed in float32).

    The (B x F) lanes flatten and pad to a multiple of ``BLOCK_LANES``;
    each grid block owns ``BLOCK_LANES`` lanes, one per thread.  Padded
    lanes carry gate = 0, z = 0 and steer = 1; their outputs are dropped.

    ``interpret=True`` runs the Pallas interpreter (CPU tests).  Otherwise
    the kernel compiles through Triton and needs a CUDA GPU.
    """
    if Z.ndim != 4:
        raise ValueError(f"pallas_mvdr_omlsa: Z must be [T, B, F, M] (4-D), got shape {Z.shape}")
    T, B, F, M = Z.shape
    for name, x in (("gate", gate), ("p", p), ("lam", lam)):
        if x.shape != (T, B, F):
            raise ValueError(f"pallas_mvdr_omlsa: {name} must be [T, B, F] = {(T, B, F)}, got {x.shape}")
    if steer.shape != (F, M):
        raise ValueError(f"pallas_mvdr_omlsa: steer must be [F, M] = {(F, M)}, got {steer.shape}")
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "pallas_mvdr_omlsa compiles through Triton and needs a CUDA GPU "
            f"(default backend is {jax.default_backend()!r}); use backend='scan', "
            "or interpret=True to run the Pallas interpreter"
        )

    E = B * F
    Ep = -(-E // BLOCK_LANES) * BLOCK_LANES
    f32 = jnp.float32

    def lanes(x, fill=0.0):  # [T, B, F(, M)] -> [T, (M,) Ep] float32
        if x.ndim == 4:
            x = jnp.swapaxes(x.reshape(T, E, M), 1, 2)
        else:
            x = x.reshape(T, E)
        pad = [(0, 0)] * (x.ndim - 1) + [(0, Ep - E)]
        return jnp.pad(x.astype(f32), pad, constant_values=fill)

    se = jnp.broadcast_to(steer[None], (B, F, M)).reshape(E, M).T  # [M, E]
    se = jnp.pad(se, [(0, 0), (0, Ep - E)], constant_values=1.0)
    operands = (
        lanes(jnp.real(Z)), lanes(jnp.imag(Z)), lanes(gate), lanes(p), lanes(lam, 1.0),
        jnp.real(se).astype(f32), jnp.imag(se).astype(f32),
    )

    zspec = pl.BlockSpec((T, M, BLOCK_LANES), lambda n: (0, 0, n))
    tspec = pl.BlockSpec((T, BLOCK_LANES), lambda n: (0, n))
    aspec = pl.BlockSpec((M, BLOCK_LANES), lambda n: (0, n))
    kern = partial(
        _mvdr_omlsa_kernel, T=T, M=M, alpha_v=alpha_v, diag=diag, rel_diag=rel_diag,
        alpha_xi=alpha_xi, gmin=gmin,
    )
    yr, yi = pl.pallas_call(
        kern,
        grid=(Ep // BLOCK_LANES,),
        in_specs=[zspec, zspec, tspec, tspec, tspec, aspec, aspec],
        out_specs=[tspec, tspec],
        out_shape=[jax.ShapeDtypeStruct((T, Ep), f32)] * 2,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name=KERNEL_NAME,
    )(*operands)
    Y = jax.lax.complex(yr[:, :E], yi[:, :E]).reshape(T, B, F)
    return Y.astype(Z.dtype)
