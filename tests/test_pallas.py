"""Fused barotropic volume kernel vs the XLA path (interpret mode).

The kernel (ops/pallas_btp.py, Pallas through Triton) must reproduce
btp_volume_rhs + the volume/nodal accumulator updates exactly (same
operations, same order up to matmul reassociation). Element counts are not
multiples of the kernel tile, so the masked tail is exercised; the compiled
kernel is checked on the card by chip_smoke.py (phase D)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hnumo_tpu.config import Config
from hnumo_tpu.model import Model


def _setup(dtype, botfr, case="double_gyre", nel=(6, 5)):
    cfg = Config(nelx=nel[0], nely=nel[1], nopx=4, nopy=4, xdims=(0.0, 2e6),
                 ydims=(0.0, 2e6), nlayers=2, dt=400.0, dt_btp=20.0,
                 time_final=1e9, test_case=case, f0=9.3e-5,
                 beta=2e-11, botfr=botfr, cd_mlswe=1e-7,
                 method_visc=2, visc_mlswe=100.0, dtype=dtype)
    return Model(cfg)


def _kernel_parity(m, seed):
    from hnumo_tpu.core.bcl import extract_qprime_faces
    from hnumo_tpu.core.btp import btp_volume_rhs
    from hnumo_tpu.core.coupling import btp_bcl_coeffs
    from hnumo_tpu.ops.dg import interp_n2q
    from hnumo_tpu.ops.pallas_btp import TILE, btp_volume_pallas, operators

    static, P, g, bc = m.static, m.P, m.g, m.bc
    ney, nex = g.wjac.shape[:2]
    assert (ney * nex) % TILE, "element count must leave a masked tail"
    s = m.state0
    # perturb the state so the test is not all-zeros
    rng = np.random.default_rng(seed)
    qb = s.qb_df + jnp.asarray(
        1e-3 * np.abs(rng.normal(size=s.qb_df.shape)), m.dtype)
    qp = s.qprime_df + jnp.asarray(
        1e-4 * rng.normal(size=s.qprime_df.shape), m.dtype)

    qpf = extract_qprime_faces(bc, qp)
    zq = jnp.zeros_like(interp_n2q(g, qp[0]))
    coup = btp_bcl_coeffs(static, P, g, bc, qp, qpf, qp[0], zq)
    qpl_q = interp_n2q(g, qp[:, -1])

    rhs_ref, vinc_ref = btp_volume_rhs(static, P, g, coup, qb, qpl_q)
    t_df = qb[1] * P.one_over_pbprime_df
    ninc_ref = jnp.stack([t_df * (2.0 + t_df), qb[2] / qb[0], qb[3] / qb[0]])

    accv0 = jnp.asarray(rng.normal(size=vinc_ref.shape), m.dtype)
    accn0 = jnp.asarray(rng.normal(size=ninc_ref.shape), m.dtype)
    rhs, accv, accn = btp_volume_pallas(
        operators(g.psiq, g.dpsiq), g, P, coup, qb, qpl_q, accv0, accn0,
        grav=static.gravity, botfr=static.botfr, cd=static.cd_mlswe,
        alpha_bot=static.alpha_bot, interpret=True)

    tol = 1e-12 if m.dtype == jnp.float64 else 2e-5
    ref = np.asarray(rhs_ref)
    np.testing.assert_allclose(np.asarray(rhs), ref,
                               atol=tol * np.abs(ref).max())
    vref = np.asarray(vinc_ref) + np.asarray(accv0)
    np.testing.assert_allclose(np.asarray(accv), vref,
                               atol=tol * np.abs(vref).max(), rtol=tol * 10)
    nref = np.asarray(ninc_ref) + np.asarray(accn0)
    np.testing.assert_allclose(np.asarray(accn), nref,
                               atol=tol * np.abs(nref).max(), rtol=tol * 10)


@pytest.mark.parametrize("botfr", [0, 1, 2])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_volume_kernel_parity(dtype, botfr):
    """Flat-bottom double gyre, 30 elements."""
    _kernel_parity(_setup(dtype, botfr), seed=0)


@pytest.mark.parametrize("botfr", [0, 1, 2])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_volume_kernel_parity_seamount(dtype, botfr):
    """Seamount: bathymetry gradients feed the source terms; 21 elements."""
    _kernel_parity(_setup(dtype, botfr, case="seamount", nel=(7, 3)), seed=1)


def test_full_step_with_pallas_interpret_matches_xla():
    """End-to-end: 2 baroclinic steps with the Pallas volume kernel
    (interpret) match the XLA path."""
    m_x = _setup("float64", 1)
    cfg_p = Config(**{**m_x.cfg.__dict__, "use_pallas": "on"})
    m_p = Model(cfg_p)
    assert m_p.static.use_pallas and m_p.static.pallas_interpret

    s_x = m_x.state0
    s_p = m_p.state0
    for _ in range(2):
        s_x = m_x.step(s_x)
        s_p = m_p.step(s_p)
    for name in ("qb_df", "q_df", "qprime_df"):
        a = np.asarray(getattr(s_x, name))
        b = np.asarray(getattr(s_p, name))
        np.testing.assert_allclose(b, a, atol=1e-11 * max(np.abs(a).max(), 1),
                                   err_msg=name)


def test_pad_elements_prime():
    """An awkward element count (61x13 = 793, prime factors only) runs the
    masked element tail of the last program; the full step matches XLA."""
    from hnumo_tpu.ops.pallas_btp import TILE

    cfg = Config(nelx=61, nely=13, nopx=4, nopy=4, xdims=(0.0, 2e6),
                 ydims=(0.0, 4e5), nlayers=2, dt=40.0, dt_btp=20.0,
                 time_final=1e9, test_case="double_gyre", f0=9.3e-5,
                 beta=2e-11, botfr=1, cd_mlswe=1e-7,
                 method_visc=2, visc_mlswe=100.0, dtype="float64")
    assert (61 * 13) % TILE
    m_x = Model(cfg)
    cfg_p = Config(**{**cfg.__dict__, "use_pallas": "on"})
    m_p = Model(cfg_p)
    s_x = m_x.step(m_x.state0)
    s_p = m_p.step(m_p.state0)
    for name in ("qb_df", "q_df", "qprime_df"):
        a = np.asarray(getattr(s_x, name))
        b = np.asarray(getattr(s_p, name))
        np.testing.assert_allclose(b, a, atol=1e-11 * max(np.abs(a).max(), 1),
                                   err_msg=name)


def test_pallas_volume_sharded_matches_serial():
    """Fused volume kernel + XLA faces under shard_map on the fake
    8-device mesh: the kernel runs on each shard's local block, and a path
    use_pallas selects must run under the active mesh."""
    from hnumo_tpu.parallel.sharding import make_mesh

    cfg = Config(nelx=8, nely=8, nopx=4, nopy=4, xdims=(0.0, 2e6),
                 ydims=(0.0, 2e6), nlayers=2, dt=400.0, dt_btp=20.0,
                 time_final=1e9, test_case="double_gyre", f0=9.3e-5,
                 beta=2e-11, botfr=1, cd_mlswe=1e-7,
                 method_visc=2, visc_mlswe=100.0, dtype="float64",
                 use_pallas="on")
    m1 = Model(cfg)
    assert m1.static.use_pallas
    mesh = make_mesh(jax.devices(), shape=(2, 4))
    mN = Model(cfg, mesh=mesh)

    s1, sN = m1.state0, mN.state0
    for _ in range(2):
        s1 = m1.step(s1)
        sN = mN.step(sN)
    for name in ("qb_df", "q_df", "qprime_df"):
        a = np.asarray(getattr(s1, name))
        b = np.asarray(getattr(sN, name))
        np.testing.assert_allclose(b, a, atol=1e-11 * max(np.abs(a).max(), 1),
                                   err_msg=name)
