"""Barotropic solver: RHS kernels + SSPRK sub-cycling with running averages.

Reference: src/mod_rhs_btp.F90 (create_rhs_btp, create_rhs_btp_volume_qdf,
creat_btp_fluxes_qdf), src/mod_rk_mlswe.F90 (ti_barotropic_ssprk_mlswe),
src/mod_barotropic_terms.F90 (btp_extract_df, btp_mom_boundary_df).

This is the innermost hot loop (N_btp * kstages evaluations per dt). The
volume kernel is batched einsums over all elements; the face kernels are
slices + small matmuls; the sub-cycling is a lax.scan over barotropic steps
with the 23 running-average accumulators carried as a BtpAverages pytree
(reference zeroes/accumulates/normalizes them imperatively,
src/mod_rk_mlswe.F90:45-149).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.dg import DeviceGeom, grad_nodal, interp_n2q, scatter_volume, scatter_volume_nodal
from .faces import (BCs, apply_wall_projection, extract_faces_multi,
                    extract_faces_stacked, face_n2q, face_quad_scatter,
                    scatter_face_x, scatter_face_y)
from .types import BtpAverages, BtpFaceAvg, CouplingFields, Pair, Precomputed


# stacked-accumulator channel orders (scan carries ONE array per family so
# each stage is a single fused add instead of ~30 separate HBM round-trips;
# the BtpAverages view is built once after the scan)
_VOL_ORDER = ("dH", "Qu", "Qv", "Quv", "mu", "mu2", "ub", "vb",
              "mfU", "mfV", "tbU", "tbV")
_NOD_ORDER = ("mu2_df", "ub_df", "vb_df")
_FACE_ORDER = ("dH", "QuU", "QuV", "QvU", "QvV", "muL", "muR", "mu2L",
               "mu2R", "fluxU", "fluxV", "mue2", "ubL", "ubR", "vbL", "vbR")


def btp_extract_df(bc: BCs, qb_df):
    """Nodal face traces of the 4 barotropic variables with BC mirrors.

    Reference btp_extract_df (src/mod_barotropic_terms.F90:25-97): pb and
    pbpert copy across walls; (pbub, pbvb) get the free-slip/no-slip mirror.
    Returns a list of 4 FaceLR.
    """
    return extract_faces_multi(qb_df, bc, vec_pairs=((2, 3),))


def btp_volume_rhs(static, P: Precomputed, g: DeviceGeom, coup: CouplingFields,
                   qb_df, qpl_q):
    """Fused barotropic volume kernel + volume average increments.

    Reference create_rhs_btp_volume_qdf (src/mod_rhs_btp.F90:102-209).
    `qpl_q`: bottom-layer primes at quad points (3, quad) — constant over
    one barotropic solve, interpolated once by the caller.
    Returns (rhs (3, nodal) without massinv, stacked increments (12, quad)
    in _VOL_ORDER).
    """
    grav = static.gravity
    qbq = interp_n2q(g, qb_df)                     # (4, quad)
    dp, dpp, udp, vdp = qbq[0], qbq[1], qbq[2], qbq[3]
    # bottom-layer primes (channel 0 carries δdp'; full needed for friction)
    pp, up, vp = P.dpp_ref_q[-1] + qpl_q[0], qpl_q[1], qpl_q[2]

    ub = udp / dp
    vb = vdp / dp

    if static.botfr == 1:      # linear bottom drag (reference :157-162)
        spd = (static.cd_mlswe / grav) * pp
        tb_u = spd * (up + ub)
        tb_v = spd * (vp + vb)
    elif static.botfr == 2:    # quadratic (reference :163-169)
        ubot, vbot = up + ub, vp + vb
        spd = (static.cd_mlswe / static.alpha_bot) * jnp.sqrt(ubot**2 + vbot**2)
        tb_u = spd * ubot
        tb_v = spd * vbot
    else:
        tb_u = jnp.zeros_like(dp)
        tb_v = jnp.zeros_like(dp)

    # δ-form pressure/source terms (docs/float32.md): the static parts
    # (H_bcl_ref flux + g*pbprime*grad(zb) source + reference edge fluxes)
    # live in the precomputed P.btp_rhs_ref vector added by create_rhs_btp.
    f = P.coriolis_quad
    sc_x = f * vdp + grav * (P.tau_wind[0] - tb_u) - grav * dpp * P.grad_zbot_quad[0]
    sc_y = -f * udp + grav * (P.tau_wind[1] - tb_v) - grav * dpp * P.grad_zbot_quad[1]

    mu = dpp * P.one_over_pbprime              # ope - 1, conditioned
    mu2 = mu * (2.0 + mu)                      # ope^2 - 1
    ope = 1.0 + mu
    dHq = coup.dH_bcl + mu2 * (P.H_bcl_ref + coup.dH_bcl)   # Hq - H_bcl_ref
    qu = ub * udp + ope * coup.Q_uu_dp
    quv = ub * vdp + ope * coup.Q_uv_dp
    qv = vb * vdp + ope * coup.Q_vv_dp

    rhs1 = scatter_volume(g, Fx=udp, Fy=vdp)
    rhs2 = scatter_volume(g, Fx=dHq + qu, Fy=quv, Fs=sc_x)
    rhs3 = scatter_volume(g, Fx=quv, Fy=dHq + qv, Fs=sc_y)
    rhs = jnp.stack([rhs1, rhs2, rhs3])

    # stacked in _VOL_ORDER
    avg_inc = jnp.stack([dHq, qu, qv, quv, mu, mu2, ub, vb, udp, vdp,
                         tb_u, tb_v])
    return rhs, avg_inc


def _flatf(a):
    """Merge the two structured face axes: (..., A, B, m) -> (..., A*B, m)."""
    return a.reshape(a.shape[:-3] + (a.shape[-3] * a.shape[-2], a.shape[-1]))


def _catf(ax_arr, ay_arr):
    """Concatenate flattened x-face and y-face tables on one flat face axis.

    The direction-agnostic face-flux math (direction enters only through the
    normal tables) then runs BOTH directions in one batched pipeline — the
    x and y face counts differ ((ly)(lx+1) vs (ly+1)(lx)) so XLA cannot
    batch the per-direction calls itself, and at small grids the duplicated
    kernel launches dominate the stage)."""
    return jnp.concatenate([_flatf(ax_arr), _flatf(ay_arr)], axis=-2)


def _face_flux_core(fg, Qe_uu, Qe_uv, Qe_vv, dHe, qblq, qbrq, pbl, pbr,
                    psiq):
    """Barotropic face flux kernel, direction-agnostic.

    Reference creat_btp_fluxes_qdf (src/mod_rhs_btp.F90:211-364).
    qblq/qbrq: (4, F..., nq) stacked quad traces; fg tables broadcastable to
    (F..., nq); pbl/pbr: one-sided reference pb' at quad points. Works on
    per-direction structured tables and on the flat concatenated layout
    alike. Returns (S_left scatter values (3, F..., ngl), BtpFaceAvg
    increments (16, F..., nq) without the graduvb slots).
    """
    nx, ny = fg.nx, fg.ny

    pU_L = nx * qblq[2] + ny * qblq[3]
    pU_R = -(nx * qbrq[2] + ny * qbrq[3])
    pbpert_edge = (fg.coeff_pbpert_L * qblq[1] + fg.coeff_pbpert_R * qbrq[1]
                   + fg.coeff_pbub_LR * (pU_L + pU_R))
    mue = pbpert_edge * fg.one_over_pbprime_edge    # ope_edge - 1
    mue2 = mue * (2.0 + mue)                        # ope_edge^2 - 1
    ope_edge = 1.0 + mue

    flux_edge_x = (fg.coeff_mass_pbub_L * qblq[2] + fg.coeff_mass_pbub_R * qbrq[2]
                   + fg.coeff_mass_pbpert_LR * nx * (qblq[1] - qbrq[1]))
    flux_edge_y = (fg.coeff_mass_pbub_L * qblq[3] + fg.coeff_mass_pbub_R * qbrq[3]
                   + fg.coeff_mass_pbpert_LR * ny * (qblq[1] - qbrq[1]))

    ul, ur = qblq[2] / qblq[0], qbrq[2] / qbrq[0]
    vl, vr = qblq[3] / qblq[0], qbrq[3] / qbrq[0]

    quu = 0.5 * (ul * qblq[2] + ur * qbrq[2]) + ope_edge * Qe_uu
    quv = 0.5 * (vl * qblq[2] + vr * qbrq[2]) + ope_edge * Qe_uv
    qvu = 0.5 * (ul * qblq[3] + ur * qbrq[3]) + ope_edge * Qe_uv
    qvv = 0.5 * (vl * qblq[3] + vr * qbrq[3]) + ope_edge * Qe_vv
    # δ-form: H_face - Hedge_ref; static part in P.btp_rhs_ref (create_rhs_btp)
    dH_face = dHe + mue2 * (fg.Hedge_ref + dHe)

    lamb = fg.coeff_mass_pbpert_LR
    dispu = 0.5 * lamb * (qbrq[2] - qblq[2])
    dispv = 0.5 * lamb * (qbrq[3] - qblq[3])
    flux_x = nx * quu + ny * quv - dispu
    flux_y = nx * qvu + ny * qvv - dispv
    flux = nx * flux_edge_x + ny * flux_edge_y
    H_kx, H_ky = nx * dH_face, ny * dH_face

    # one batched quad->nodal face projection for all 3 scatter channels
    S = face_quad_scatter(psiq, fg.jac,
                          jnp.stack([flux, H_kx + flux_x, H_ky + flux_y]))

    muL = qblq[1] / pbl
    muR = qbrq[1] / pbr
    # stacked in _FACE_ORDER
    inc = jnp.stack([dH_face, quu, quv, qvu, qvv, muL, muR,
                     muL * (2.0 + muL), muR * (2.0 + muR),
                     flux_edge_x, flux_edge_y, mue2, ul, ur, vl, vr])
    return S, inc


def _face_flux_dir(static, fg, Qe_uu, Qe_uv, Qe_vv, dHe, traces, psiq):
    """Per-direction wrapper of _face_flux_core (legacy structured path).

    traces: list of 4 (L, R) nodal trace pairs."""
    qblq = face_n2q(psiq, jnp.stack([t[0] for t in traces]))
    qbrq = face_n2q(psiq, jnp.stack([t[1] for t in traces]))
    # one-sided reference pb' interpolated from nodal face values (:257-258)
    pbl = face_n2q(psiq, fg.pbprime_df_face_L)
    pbr = face_n2q(psiq, fg.pbprime_df_face_R)
    return _face_flux_core(fg, Qe_uu, Qe_uv, Qe_vv, dHe, qblq, qbrq,
                           pbl, pbr, psiq)


def btp_nodal_laplacian(static, P: Precomputed, g: DeviceGeom, bc: BCs,
                        coup: CouplingFields, qb_df):
    """Nodal-family LDG barotropic viscosity (method_visc != 1).

    Reference btp_create_laplacian (src/mod_laplacian_quad.F90:32-121).
    Returns (rhs_lap (2, nodal), graduv (4, nodal), graduv_face Pair of
    (4, 2, F, ngl)) — the latter two feed the graduvb averages.
    """
    Uk_u = qb_df[2] / qb_df[0]
    Uk_v = qb_df[3] / qb_df[0]
    gux, guy = grad_nodal(g, Uk_u)
    gvx, gvy = grad_nodal(g, Uk_v)
    graduv = jnp.stack([gux, guy, gvx, gvy])

    fg = extract_faces_multi(graduv, bc, vec_pairs=((0, 1), (2, 3)))
    gface_x = jnp.stack([jnp.stack([f.xl for f in fg]),
                         jnp.stack([f.xr for f in fg])], axis=1)
    gface_y = jnp.stack([jnp.stack([f.yl for f in fg]),
                         jnp.stack([f.yr for f in fg])], axis=1)

    # volume (reference btp_compute_laplacian :357-390): note the MINUS sign
    qq = coup.pbprime_visc[None] * graduv + coup.btp_dpp_graduv
    lap_u = -scatter_volume_nodal(g, qq[0], qq[1])
    lap_v = -scatter_volume_nodal(g, qq[2], qq[3])

    # face flux (reference create_rhs_laplacian_flux :427-519): nodal-resolution
    # faces, psi = identity, flip-flop central flux; L gets +, R gets -
    def face_dir(gface, bgf, nx_df, ny_df, jac_df):
        # gface: (4, 2, F, ngl); bgf: (5, 2, F, ngl)
        fl = bgf[4, 0] * gface[:, 0] + bgf[:4, 0]   # (4, F, ngl)
        fr = bgf[4, 1] * gface[:, 1] + bgf[:4, 1]
        qmean = 0.5 * (fl + fr)
        flux_qu = (qmean[0] - fl[0] * nx_df) + (qmean[1] - fl[1] * ny_df)
        flux_qv = (qmean[2] - fl[2] * nx_df) + (qmean[3] - fl[3] * ny_df)
        return jac_df * flux_qu, jac_df * flux_qv

    fgx, fgy = P.faces.x, P.faces.y
    SxU, SxV = face_dir(gface_x, coup.btp_graduv_dpp_face.x, fgx.nx_df, fgx.ny_df, fgx.jac_df)
    SyU, SyV = face_dir(gface_y, coup.btp_graduv_dpp_face.y, fgy.nx_df, fgy.ny_df, fgy.jac_df)

    lap_u = scatter_face_x(lap_u, -SxU, bc)
    lap_u = scatter_face_y(lap_u, -SyU, bc)
    lap_v = scatter_face_x(lap_v, -SxV, bc)
    lap_v = scatter_face_y(lap_v, -SyV, bc)

    rhs_lap = static.visc_mlswe * g.massinv * jnp.stack([lap_u, lap_v])
    return rhs_lap, graduv, Pair(gface_x, gface_y)


def _btp_faces_visc(static, P: Precomputed, g: DeviceGeom, bc: BCs,
                    coup: CouplingFields, qb_df, qprime_df, rhs):
    """Face fluxes + static δ-form terms + massinv + viscosity — everything
    in a barotropic RHS evaluation except the volume kernel (reference
    create_rhs_btp, src/mod_rhs_btp.F90:38-57).
    Returns (rhs, inc_x (16,Fx,nq), inc_y, graduv (4,nodal),
    gface Pair of (4,2,F,ngl))."""
    traces = btp_extract_df(bc, qb_df)

    fx = P.faces.x
    fy = P.faces.y
    Sx, inc_x = _face_flux_dir(static, fx, coup.Q_uu_dp_edge.x, coup.Q_uv_dp_edge.x,
                               coup.Q_vv_dp_edge.x, coup.dH_bcl_edge.x,
                               [(t.xl, t.xr) for t in traces], g.psiq)
    Sy, inc_y = _face_flux_dir(static, fy, coup.Q_uu_dp_edge.y, coup.Q_uv_dp_edge.y,
                               coup.Q_vv_dp_edge.y, coup.dH_bcl_edge.y,
                               [(t.yl, t.yr) for t in traces], g.psiq)
    rhs = scatter_face_x(rhs, Sx, bc)
    rhs = scatter_face_y(rhs, Sy, bc)
    rhs = rhs + P.btp_rhs_ref          # static reference terms (δ-form)
    rhs = g.massinv * rhs

    if static.use_visc:
        if static.method_visc == 1:
            from .viscosity import btp_quad_laplacian
            rhs_visc, graduv, gface = btp_quad_laplacian(static, P, g, bc, coup, qb_df, qprime_df)
        else:
            rhs_visc, graduv, gface = btp_nodal_laplacian(static, P, g, bc, coup, qb_df)
        rhs = rhs.at[1:].add(rhs_visc)
    else:
        graduv = jnp.zeros((4,) + qb_df.shape[1:], qb_df.dtype)
        gface = Pair(jnp.zeros((4, 2) + traces[0].xl.shape, qb_df.dtype),
                     jnp.zeros((4, 2) + traces[0].yl.shape, qb_df.dtype))

    return rhs, inc_x, inc_y, graduv, gface


class _FlatFaceGeom(NamedTuple):
    """The FaceDirGeom subset the batched (flat-axis) face path reads —
    only these tables are concatenated per solve (the multi-layer
    reference tables dpp_ref_face*, P_ref_edge, Hk_ref_edge, z_ref_face
    are consumed by the baroclinic path on the structured view only)."""

    nx: jnp.ndarray
    ny: jnp.ndarray
    jac: jnp.ndarray
    nx_df: jnp.ndarray
    ny_df: jnp.ndarray
    jac_df: jnp.ndarray
    coeff_pbpert_L: jnp.ndarray
    coeff_pbpert_R: jnp.ndarray
    coeff_pbub_LR: jnp.ndarray
    coeff_mass_pbub_L: jnp.ndarray
    coeff_mass_pbub_R: jnp.ndarray
    coeff_mass_pbpert_LR: jnp.ndarray
    one_over_pbprime_edge: jnp.ndarray
    Hedge_ref: jnp.ndarray
    pbprime_df_face_L: jnp.ndarray
    pbprime_df_face_R: jnp.ndarray


def _build_flat_faces(static, P: Precomputed, g: DeviceGeom,
                      coup: CouplingFields):
    """Per-solve flat face bundle for the batched face path.

    Concatenates the consumed per-direction face tables ([x-faces; y-faces]
    on one flat axis) once per barotropic solve — amortized over
    N_btp*kstages stages — and hoists the stage-invariant reference pb'
    interpolation. Returns (fgf, (Qe_uu, Qe_uv, Qe_vv, dHe), pbl, pbr,
    bgf)."""
    fx, fy = P.faces.x, P.faces.y
    fgf = _FlatFaceGeom(*[_catf(getattr(fx, f), getattr(fy, f))
                          for f in _FlatFaceGeom._fields])
    Qe = tuple(_catf(p.x, p.y) for p in (coup.Q_uu_dp_edge,
                                         coup.Q_uv_dp_edge,
                                         coup.Q_vv_dp_edge,
                                         coup.dH_bcl_edge))
    pbl = face_n2q(g.psiq, fgf.pbprime_df_face_L)
    pbr = face_n2q(g.psiq, fgf.pbprime_df_face_R)
    bgf = (_catf(coup.btp_graduv_dpp_face.x, coup.btp_graduv_dpp_face.y)
           if static.use_visc else None)
    return fgf, Qe, pbl, pbr, bgf


def _nodal_laplacian_flat(static, P: Precomputed, g: DeviceGeom, bc: BCs,
                          coup: CouplingFields, flat, qb_df):
    """btp_nodal_laplacian with the face pipeline batched over the flat
    face axis (values identical; see _catf)."""
    fgf, _, _, _, bgf = flat
    ney, nex = g.wjac.shape[0], g.wjac.shape[1]
    ngl = g.wjac_df.shape[-1]
    Fx = ney * (nex + 1)

    Uk_u = qb_df[2] / qb_df[0]
    Uk_v = qb_df[3] / qb_df[0]
    gux, guy = grad_nodal(g, Uk_u)
    gvx, gvy = grad_nodal(g, Uk_v)
    graduv = jnp.stack([gux, guy, gvx, gvy])

    xl, xr, yl, yr = extract_faces_stacked(graduv, bc,
                                           vec_pairs=((0, 1), (2, 3)))
    gl = _catf(xl, yl)                      # (4, F, ngl)
    gr = _catf(xr, yr)

    qq = coup.pbprime_visc[None] * graduv + coup.btp_dpp_graduv
    lap_u = -scatter_volume_nodal(g, qq[0], qq[1])
    lap_v = -scatter_volume_nodal(g, qq[2], qq[3])

    fl = bgf[4, 0] * gl + bgf[:4, 0]
    fr = bgf[4, 1] * gr + bgf[:4, 1]
    qmean = 0.5 * (fl + fr)
    flux_qu = ((qmean[0] - fl[0] * fgf.nx_df)
               + (qmean[1] - fl[1] * fgf.ny_df))
    flux_qv = ((qmean[2] - fl[2] * fgf.nx_df)
               + (qmean[3] - fl[3] * fgf.ny_df))
    S = fgf.jac_df * jnp.stack([flux_qu, flux_qv])   # (2, F, ngl)

    Sx = S[:, :Fx].reshape(2, ney, nex + 1, ngl)
    Sy = S[:, Fx:].reshape(2, ney + 1, nex, ngl)
    lap_u = scatter_face_x(lap_u, -Sx[0], bc)
    lap_u = scatter_face_y(lap_u, -Sy[0], bc)
    lap_v = scatter_face_x(lap_v, -Sx[1], bc)
    lap_v = scatter_face_y(lap_v, -Sy[1], bc)

    rhs_lap = static.visc_mlswe * g.massinv * jnp.stack([lap_u, lap_v])
    gface_flat = jnp.stack([gl, gr], axis=1)         # (4, 2, F, ngl)
    return rhs_lap, graduv, gface_flat


def _btp_faces_visc_flat(static, P: Precomputed, g: DeviceGeom, bc: BCs,
                         coup: CouplingFields, flat, qb_df, qprime_df, rhs):
    """_btp_faces_visc with both face directions batched on one flat axis.

    Returns (rhs, inc (16, F, nq), graduv (4, nodal),
    gface_flat (4, 2, F, ngl))."""
    fgf, (Qe_uu, Qe_uv, Qe_vv, dHe), pbl, pbr, _ = flat
    ney, nex = g.wjac.shape[0], g.wjac.shape[1]
    ngl = g.wjac_df.shape[-1]
    Fx = ney * (nex + 1)
    F = Fx + (ney + 1) * nex

    xl, xr, yl, yr = extract_faces_stacked(qb_df, bc, vec_pairs=((2, 3),))
    qblq = face_n2q(g.psiq, _catf(xl, yl))    # (4, F, nq) one matmul
    qbrq = face_n2q(g.psiq, _catf(xr, yr))

    S, inc = _face_flux_core(fgf, Qe_uu, Qe_uv, Qe_vv, dHe, qblq, qbrq,
                             pbl, pbr, g.psiq)
    Sx = S[:, :Fx].reshape(3, ney, nex + 1, ngl)
    Sy = S[:, Fx:].reshape(3, ney + 1, nex, ngl)
    rhs = scatter_face_x(rhs, Sx, bc)
    rhs = scatter_face_y(rhs, Sy, bc)
    rhs = rhs + P.btp_rhs_ref          # static reference terms (δ-form)
    rhs = g.massinv * rhs

    if static.use_visc:
        # batched path requires the nodal LDG family (init gates the flag)
        rhs_visc, graduv, gface_flat = _nodal_laplacian_flat(
            static, P, g, bc, coup, flat, qb_df)
        rhs = rhs.at[1:].add(rhs_visc)
    else:
        graduv = jnp.zeros((4,) + qb_df.shape[1:], qb_df.dtype)
        gface_flat = jnp.zeros((4, 2, F, ngl), qb_df.dtype)

    return rhs, inc, graduv, gface_flat


def create_rhs_btp(static, P: Precomputed, g: DeviceGeom, bc: BCs,
                   coup: CouplingFields, qb_df, qprime_df):
    """One barotropic RHS evaluation (reference create_rhs_btp,
    src/mod_rhs_btp.F90:28-59). Returns (rhs (3, nodal), stacked average
    increments)."""
    qpl_q = interp_n2q(g, qprime_df[:, -1])
    rhs, vol_inc = btp_volume_rhs(static, P, g, coup, qb_df, qpl_q)
    rhs, inc_x, inc_y, graduv, gface = _btp_faces_visc(
        static, P, g, bc, coup, qb_df, qprime_df, rhs)
    return rhs, vol_inc, inc_x, inc_y, graduv, gface


def _averages_view(static, vol, nod, fxa, fya, gvx, gvy, graduvb) -> BtpAverages:
    """Build the BtpAverages pytree from the stacked accumulators."""
    def face(fa, gv):
        return BtpFaceAvg(**dict(zip(_FACE_ORDER, fa)), gvL=gv[0], gvR=gv[1])

    return BtpAverages(**dict(zip(_VOL_ORDER, vol)),
                       **dict(zip(_NOD_ORDER, nod)),
                       graduvb=graduvb,
                       faces=Pair(face(fxa, gvx), face(fya, gvy)))


def barotropic_solve(static, P: Precomputed, g: DeviceGeom, bc: BCs,
                     coup: CouplingFields, qb_df, qprime_df):
    """SSPRK barotropic sub-cycling over N_btp steps x kstages stages.

    Reference ti_barotropic_ssprk_mlswe (src/mod_rk_mlswe.F90:19-151).
    The 23 running averages are carried as 7 stacked accumulator arrays
    (one fused add per family per stage); when static.use_pallas the fused
    volume kernel (ops.pallas_btp) computes the volume RHS and updates the
    volume/nodal accumulators in place.
    Returns (qb_df at t+dt, normalized BtpAverages).
    """
    dtype = qb_df.dtype
    ney, nex = g.wjac.shape[0], g.wjac.shape[1]
    nq, ngl = g.wjac.shape[-1], g.wjac_df.shape[-1]
    accv0 = jnp.zeros((12, ney, nex, nq, nq), dtype)
    accn0 = jnp.zeros((3, ney, nex, ngl, ngl), dtype)
    Fx = ney * (nex + 1)
    F = Fx + (ney + 1) * nex
    if static.batched_faces:
        # batched face path: ONE flat face accumulator per family (both
        # directions), split back to the structured view after the scan
        acc0 = (accv0, accn0,
                jnp.zeros((16, F, nq), dtype),              # all faces
                jnp.zeros((2, 4, F, ngl), dtype),           # graduv L/R
                jnp.zeros((4, ney, nex, ngl, ngl), dtype))  # graduvb nodal
    else:
        acc0 = (accv0, accn0,
                jnp.zeros((16, ney, nex + 1, nq), dtype),     # x-faces
                jnp.zeros((16, ney + 1, nex, nq), dtype),     # y-faces
                jnp.zeros((2, 4, ney, nex + 1, ngl), dtype),  # graduv x L/R
                jnp.zeros((2, 4, ney + 1, nex, ngl), dtype),  # graduv y L/R
                jnp.zeros((4, ney, nex, ngl, ngl), dtype))    # graduvb nodal

    # under shard_map the scan carry must be device-varying from the start
    axes = tuple(a for a in (bc.ax, bc.ay) if a is not None)

    def _vary(x):
        vma = getattr(jax.typeof(x), "vma", frozenset())
        need = tuple(a for a in axes if a not in vma)
        return jax.lax.pcast(x, need, to="varying") if need else x

    if axes:
        acc0 = jax.tree_util.tree_map(_vary, acc0)
    a = P.ssprk_a
    beta = P.ssprk_beta
    kstages = static.kstages

    # constant over the whole solve: bottom-layer primes at quad points
    qpl_q = interp_n2q(g, qprime_df[:, -1])
    if static.use_pallas:
        from ..ops.pallas_btp import btp_volume_pallas, operators

        ops = operators(g.psiq, g.dpsiq)

    def stage_volume(qb1, accv, accn):
        """Volume RHS + volume/nodal accumulator update for one stage."""
        if static.use_pallas:
            return btp_volume_pallas(
                ops, g, P, coup, qb1, qpl_q, accv, accn,
                grav=static.gravity, botfr=static.botfr, cd=static.cd_mlswe,
                alpha_bot=static.alpha_bot,
                interpret=static.pallas_interpret)
        # XLA path: nodal accumulators BEFORE the stage RHS (reference :90-92);
        # mu2_df = ope_df^2 - 1 stored in conditioned form
        t_df = qb1[1] * P.one_over_pbprime_df
        incn = jnp.stack([t_df * (2.0 + t_df),
                          qb1[2] / qb1[0], qb1[3] / qb1[0]])
        rhs, vol_inc = btp_volume_rhs(static, P, g, coup, qb1, qpl_q)
        return rhs, accv + vol_inc, accn + incn

    lsrk = static.ti_method_btp == "lsrk"
    flat = (_build_flat_faces(static, P, g, coup)
            if static.batched_faces else None)

    def one_btp_step(carry, _):
        qb0 = carry[0]

        def stage_body(st, sx):
            """One SSPRK/LSRK stage. `sx` = (a_row, beta_ik, ik); ik is a
            Python int when unrolled, a traced scalar under scan_stages."""
            a_row, beta_ik, ik = sx
            if static.batched_faces:
                qb1, qb2, accv, accn, aff, agf, agrad = st
            else:
                qb1, qb2, accv, accn, afx, afy, agx, agy, agrad = st
            rhs, accv, accn = stage_volume(qb1, accv, accn)
            if static.batched_faces:
                rhs, inc, graduv, gface_flat = _btp_faces_visc_flat(
                    static, P, g, bc, coup, flat, qb1, qprime_df, rhs)
                aff = aff + inc
                agf = agf + jnp.swapaxes(gface_flat, 0, 1)
            else:
                rhs, inc_x, inc_y, graduv, gface = _btp_faces_visc(
                    static, P, g, bc, coup, qb1, qprime_df, rhs)
                afx = afx + inc_x
                afy = afy + inc_y
                agx = agx + jnp.swapaxes(gface.x, 0, 1)
                agy = agy + jnp.swapaxes(gface.y, 0, 1)
            agrad = agrad + graduv

            if lsrk:
                # correct 2N-register low-storage RK (Carpenter & Kennedy
                # 1994): dq = A_k dq + dt f(q); q += B_k dq. The reference's
                # own LSRK branch feeds these tables through its 3-register
                # SSP update (src/mod_rk_mlswe.F90:99-106), which is
                # inconsistent and diverges — kept as 'lsrk_ref' only.
                # Here qb2 carries the dq register (thickness/momentum rows).
                dq = a_row[0] * qb2[1:4] + static.dt_btp * rhs
                new234 = qb1[1:4] + beta_ik * dq
                qb2 = jnp.concatenate([jnp.zeros_like(dq[:1]), dq])
            else:
                dtt = static.dt_btp * beta_ik
                new234 = (a_row[0] * qb0[1:4] + a_row[1] * qb1[1:4]
                          + a_row[2] * qb2[1:4] + dtt * rhs)
            pb = new234[0] + P.pbprime_df
            qu, qv = apply_wall_projection(new234[1], new234[2], bc)
            qb1 = jnp.stack([pb, new234[0], qu, qv])
            if not lsrk and kstages == 5:
                # SSP(5,3) snapshots the stage-2 state into the third register
                if isinstance(ik, int):
                    qb2 = qb1 if ik == 1 else qb2
                else:
                    qb2 = jnp.where(ik == 1, qb1, qb2)
            if static.batched_faces:
                return (qb1, qb2, accv, accn, aff, agf, agrad), None
            return (qb1, qb2, accv, accn, afx, afy, agx, agy, agrad), None

        if static.scan_stages:
            # one compiled stage body, scanned over the coefficient tables:
            # ~kstages x smaller step HLO and compile time
            carry, _ = jax.lax.scan(
                stage_body, carry, (a, beta, jnp.arange(kstages)))
        else:
            for ik in range(kstages):
                carry, _ = stage_body(carry, (a[ik], beta[ik], ik))
        if lsrk:
            # dq register resets every btp step
            carry = carry[:1] + (jnp.zeros_like(carry[1]),) + carry[2:]
        return carry, None

    qb2_0 = jnp.zeros_like(qb_df)
    if axes:
        qb2_0 = _vary(qb2_0)
    (qb, _, *accs), _ = jax.lax.scan(
        one_btp_step, (qb_df, qb2_0) + acc0, None, length=static.n_btp)

    n_inv = jnp.asarray(1.0 / (kstages * static.n_btp), dtype)
    if static.batched_faces:
        vol, nod, aff, agf, agrad = (acc * n_inv for acc in accs)
        # split the flat face accumulators back to the structured view
        afx = aff[:, :Fx].reshape(16, ney, nex + 1, nq)
        afy = aff[:, Fx:].reshape(16, ney + 1, nex, nq)
        agx = agf[:, :, :Fx].reshape(2, 4, ney, nex + 1, ngl)
        agy = agf[:, :, Fx:].reshape(2, 4, ney + 1, nex, ngl)
    else:
        vol, nod, afx, afy, agx, agy, agrad = (acc * n_inv for acc in accs)
    return qb, _averages_view(static, vol, nod, afx, afy, agx, agy, agrad)
