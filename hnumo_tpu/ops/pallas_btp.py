"""Fused barotropic volume RHS + average accumulation (Pallas, Triton route).

The innermost hot op of the model: `btp_volume_rhs` + the volume/nodal
average accumulators run N_btp*kstages times per barotropic solve, twice
per baroclinic dt (reference create_rhs_btp_volume_qdf,
src/mod_rhs_btp.F90:102-209, plus the accumulator updates of
src/mod_rk_mlswe.F90:84-98). The XLA path writes ~20 quad-sized
intermediates to device memory per stage and launches one kernel per
fusion; this kernel keeps the whole per-element pipeline (node->quad
interp, friction/sources, flux tensors, weak-form scatter, 12 quad + 3
nodal accumulator adds) in registers, one program per tile of elements,
with the accumulators updated in place via input_output_aliases.

Layouts are the model's own structured arrays viewed element-flat, which is
a free reshape: nodal (C*E, npts) with npts = ngl*ngl, quad (C*E, nqq) with
nqq = nq*nq, row c*E + e. The 2D tensor-product operators become single
matmuls with Kronecker-product matrices:
  interp     u_q = u_n @ K,           K[n,Q]  = psi_j(J) psi_i(I)
  scatter    r_n = a_ksi @ DkT + a_eta @ DeT + s @ KT
where DkT[Q,n] = psi_j(J) dpsi_i(I), DeT[Q,n] = dpsi_j(J) psi_i(I) — the
flattened form of ops.dg.scatter_volume. Triton wants power-of-two tiles,
so the operators are zero-padded (p=4: npts 25->32, nqq 81->128) and every
load and store is masked on the element tail and the padded columns. All
work at a quad point is local to it, so a program walks the quad points in
chunks and sums the chunks' scatter products. A chunk's operator block is
capped at OP_CHUNK_ELEMS values (32 KB in f32): one chunk at p=4, five at
p=8, whose unchunked operators would not fit in a block's 227 KB of shared
memory.

Matmuls run at HIGHEST precision (IEEE f32 on the GPU, never TF32: a
three-digit product is the failure documented in docs/float32.md). Triton's
dot has no f64 accumulator, so on the GPU the kernel is f32 only; CPU tests
run it in interpret mode in both precisions.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# elements per program (Triton dots need >= 16 rows) and warps: on the H100
# 16 x 8 beat 16 x 4, 16 x 16 and 32 x 8 (docs/performance.md)
TILE = 16
NUM_WARPS = 8
OP_CHUNK_ELEMS = 8192  # values in one (NP, chunk width) operator block


def _pow2(n: int) -> int:
    return 1 << max(4, (n - 1).bit_length())


def _quad_chunks(npts: int, nqq: int) -> tuple[int, int]:
    """(chunk width, number of chunks) covering nqq quad points."""
    width = min(_pow2(nqq), max(16, OP_CHUNK_ELEMS // _pow2(npts)))
    return width, -(-nqq // width)


class BtpVolOperators(NamedTuple):
    """Zero-padded Kronecker operator matrices (NP = pow2(npts), NQ = the
    quad chunks' total width)."""

    K: jnp.ndarray      # (NP, NQ) node->quad interp
    KT: jnp.ndarray     # (NQ, NP) quad->node scatter (Fs term)
    DkT: jnp.ndarray    # (NQ, NP) d/dksi-weighted scatter
    DeT: jnp.ndarray    # (NQ, NP)


def operators(psiq, dpsiq) -> BtpVolOperators:
    """Padded operator matrices from the 1D basis tables (ngl, nq)."""
    ngl, nq = psiq.shape
    npts, nqq = ngl * ngl, nq * nq
    width, nchunks = _quad_chunks(npts, nqq)
    NP, NQ = _pow2(npts), width * nchunks
    K = jnp.einsum("jJ,iI->jiJI", psiq, psiq).reshape(npts, nqq)
    Dk = jnp.einsum("jJ,iI->jiJI", psiq, dpsiq).reshape(npts, nqq)
    De = jnp.einsum("jJ,iI->jiJI", dpsiq, psiq).reshape(npts, nqq)

    def pad(m):
        return jnp.pad(m, ((0, NP - npts), (0, NQ - nqq)))

    return BtpVolOperators(K=pad(K), KT=pad(K).T, DkT=pad(Dk).T,
                           DeT=pad(De).T)


def eflat(a):
    """(..., ney, nex, m, m) -> (prod(...)*E, m*m): channel-major element
    rows (a free reshape). Works on the LOCAL block under shard_map."""
    return a.reshape(-1, a.shape[-2] * a.shape[-1])


def sds(shape, dtype, *operands):
    """ShapeDtypeStruct for pallas_call outputs, carrying the union of the
    operands' varying-manual-axes (vma). Under jax.shard_map with
    check_vma=True, pallas_call outputs must declare which mesh axes they
    vary over; a kernel output varies over exactly the axes any of its
    inputs varies over (the kernel is per-shard-local)."""
    vma = frozenset()
    for a in operands:
        vma = vma | getattr(jax.typeof(a), "vma", frozenset())
    if vma:
        return jax.ShapeDtypeStruct(shape, dtype, vma=vma)
    return jax.ShapeDtypeStruct(shape, dtype)


def align_vma(*arrays):
    """Promote every array to the union of the group's varying-manual-axes.

    Under jax.shard_map (check_vma=True) pallas_call operands must agree on
    which mesh axes they vary over; the operator matrices are replicated
    while the state is device-varying, so pcast them up to match. Outside
    shard_map this is the identity."""
    vma = frozenset()
    for a in arrays:
        vma = vma | getattr(jax.typeof(a), "vma", frozenset())
    if not vma:
        return arrays
    out = []
    for a in arrays:
        have = getattr(jax.typeof(a), "vma", frozenset())
        need = tuple(ax for ax in vma if ax not in have)
        out.append(jax.lax.pcast(a, need, to="varying") if need else a)
    return tuple(out)


def _kernel(qb_ref, qpl_ref, kx_ref, ky_ref, ex_ref, ey_ref, wj_ref,
            cor_ref, tau_ref, gz_ref, opbp_ref, dppref_ref, href_ref,
            quu_ref, quv_ref, qvv_ref, dhb_ref, pbp_ref,
            K_ref, KT_ref, DkT_ref, DeT_ref, accv_in, accn_in,
            rhs_ref, accv_ref, accn_ref,
            *, E, npts, nqq, T, lref, grav, botfr, cd, alpha_bot):
    NP = K_ref.shape[0]
    QW, nchunks = _quad_chunks(npts, nqq)
    e = pl.program_id(0) * T + jnp.arange(T, dtype=jnp.int32)
    emask = e < E
    cn = jnp.arange(NP, dtype=jnp.int32)
    mn = emask[:, None] & (cn < npts)[None, :]

    def ldn(ref, c=0):
        return plgpu.load(ref.at[(c * E + e)[:, None], cn[None, :]],
                          mask=mn, other=0.0)

    def stn(ref, c, v):
        plgpu.store(ref.at[(c * E + e)[:, None], cn[None, :]], v, mask=mn)

    hi = jax.lax.Precision.HIGHEST
    pet = qb_ref.dtype

    def dot(a, b):
        return jnp.dot(a, b, precision=hi, preferred_element_type=pet)

    qb0 = jnp.where(mn, ldn(qb_ref, 0), 1.0)
    qb1, qb2, qb3 = ldn(qb_ref, 1), ldn(qb_ref, 2), ldn(qb_ref, 3)

    # nodal averages, computed from the PRE-stage qb (reference :90-92)
    t_df = qb1 * ldn(pbp_ref)
    inv_pb = 1.0 / qb0
    for c, v in enumerate((t_df * (2.0 + t_df), qb2 * inv_pb, qb3 * inv_pb)):
        stn(accn_ref, c, ldn(accn_in, c) + v)   # accn_in aliases accn_ref

    rhs = [jnp.zeros((T, NP), pet) for _ in range(3)]
    for ch in range(nchunks):
        cq = ch * QW + jnp.arange(QW, dtype=jnp.int32)
        mq = emask[:, None] & (cq < nqq)[None, :]
        cols = pl.ds(ch * QW, QW)

        def ldq(ref, c=0, cq=cq, mq=mq):
            return plgpu.load(ref.at[(c * E + e)[:, None], cq[None, :]],
                              mask=mq, other=0.0)

        def acc_q(c, v, cq=cq, mq=mq):   # accv_in aliases accv_ref
            idx = ((c * E + e)[:, None], cq[None, :])
            plgpu.store(accv_ref.at[idx],
                        plgpu.load(accv_in.at[idx], mask=mq, other=0.0) + v,
                        mask=mq)

        K = K_ref[:, cols]
        dp = jnp.where(mq, dot(qb0, K), 1.0)
        dpp, udp, vdp = dot(qb1, K), dot(qb2, K), dot(qb3, K)
        ub = udp / dp
        vb = vdp / dp
        acc_q(6, ub)
        acc_q(7, vb)
        acc_q(8, udp)
        acc_q(9, vdp)

        if botfr == 1:
            pp = ldq(dppref_ref, lref) + ldq(qpl_ref, 0)   # full bottom dp'
            spd = (cd / grav) * pp
            tb_u = spd * (ldq(qpl_ref, 1) + ub)
            tb_v = spd * (ldq(qpl_ref, 2) + vb)
        elif botfr == 2:
            ubot = ldq(qpl_ref, 1) + ub
            vbot = ldq(qpl_ref, 2) + vb
            spd = (cd / alpha_bot) * jnp.sqrt(ubot * ubot + vbot * vbot)
            tb_u = spd * ubot
            tb_v = spd * vbot
        else:
            tb_u = jnp.zeros_like(dp)
            tb_v = jnp.zeros_like(dp)
        acc_q(10, tb_u)
        acc_q(11, tb_v)

        cor = ldq(cor_ref)
        sc_x = (cor * vdp + grav * (ldq(tau_ref, 0) - tb_u)
                - grav * dpp * ldq(gz_ref, 0))
        sc_y = (-cor * udp + grav * (ldq(tau_ref, 1) - tb_v)
                - grav * dpp * ldq(gz_ref, 1))

        mu = dpp * ldq(opbp_ref)
        mu2 = mu * (2.0 + mu)
        ope = 1.0 + mu
        acc_q(4, mu)
        acc_q(5, mu2)
        dhb = ldq(dhb_ref)
        dHq = dhb + mu2 * (ldq(href_ref) + dhb)
        qu = ub * udp + ope * ldq(quu_ref)
        quv = ub * vdp + ope * ldq(quv_ref)
        qv = vb * vdp + ope * ldq(qvv_ref)
        acc_q(0, dHq)
        acc_q(1, qu)
        acc_q(2, qv)
        acc_q(3, quv)

        kx, ky, ex, ey = ldq(kx_ref), ldq(ky_ref), ldq(ex_ref), ldq(ey_ref)
        wj = ldq(wj_ref)
        DkT, DeT, KT = DkT_ref[cols, :], DeT_ref[cols, :], KT_ref[cols, :]

        def scatter(Fx, Fy, DkT=DkT, DeT=DeT, wj=wj, kx=kx, ky=ky, ex=ex,
                    ey=ey):
            return (dot(wj * (Fx * kx + Fy * ky), DkT)
                    + dot(wj * (Fx * ex + Fy * ey), DeT))

        rhs[0] += scatter(udp, vdp)
        rhs[1] += scatter(dHq + qu, quv) + dot(wj * sc_x, KT)
        rhs[2] += scatter(quv, dHq + qv) + dot(wj * sc_y, KT)

    for c in range(3):
        stn(rhs_ref, c, rhs[c])


@functools.partial(jax.jit, static_argnames=("grav", "botfr", "cd",
                                             "alpha_bot", "interpret"))
def btp_volume_pallas(ops: BtpVolOperators, g, P, coup, qb, qpl_q, accv,
                      accn, *, grav, botfr, cd, alpha_bot, interpret=False):
    """Run the fused volume kernel on one element block.

    g: DeviceGeom; P: Precomputed; coup: CouplingFields. qb (4, ney, nex,
    ngl, ngl) nodal barotropic state; qpl_q (3, ney, nex, nq, nq) bottom-
    layer primes at quad points (channel 0 = δdp'; constant over a solve);
    accv (12, ney, nex, nq, nq) and accn (3, ney, nex, ngl, ngl) running
    sums in btp._VOL_ORDER / _NOD_ORDER, updated in place. Returns
    (rhs (3, ney, nex, ngl, ngl) without massinv, accv', accn').
    """
    ney, nex, ngl = qb.shape[1], qb.shape[2], qb.shape[-1]
    nq = qpl_q.shape[-1]
    E, npts, nqq = ney * nex, ngl * ngl, nq * nq
    nlay = P.dpp_ref_q.shape[0]
    dtype = qb.dtype

    kernel = functools.partial(
        _kernel, E=E, npts=npts, nqq=nqq, T=TILE, lref=nlay - 1, grav=grav,
        botfr=botfr, cd=cd, alpha_bot=alpha_bot)
    operands = [eflat(qb), eflat(qpl_q),
                eflat(g.ksiq_x), eflat(g.ksiq_y), eflat(g.etaq_x),
                eflat(g.etaq_y), eflat(g.wjac),
                eflat(P.coriolis_quad), eflat(P.tau_wind),
                eflat(P.grad_zbot_quad), eflat(P.one_over_pbprime),
                eflat(P.dpp_ref_q), eflat(P.H_bcl_ref),
                eflat(coup.Q_uu_dp), eflat(coup.Q_uv_dp),
                eflat(coup.Q_vv_dp), eflat(coup.dH_bcl),
                eflat(P.one_over_pbprime_df),
                ops.K.astype(dtype), ops.KT.astype(dtype),
                ops.DkT.astype(dtype), ops.DeT.astype(dtype),
                eflat(accv), eflat(accn)]
    n_in = len(operands)
    rhs, accv2, accn2 = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(E, TILE),),
        out_shape=[sds((3 * E, npts), dtype, qb, accv),
                   sds((12 * E, nqq), dtype, qb, accv),
                   sds((3 * E, npts), dtype, qb, accn)],
        input_output_aliases={n_in - 2: 1, n_in - 1: 2},
        interpret=interpret,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        name="btp_volume",
    )(*align_vma(*operands))
    return (rhs.reshape(3, ney, nex, ngl, ngl), accv2.reshape(accv.shape),
            accn2.reshape(accn.shape))
