"""Coverage for config branches not exercised by the golden gates.

Option coverage: vertical-shear tridiagonal solve (ad_mlswe>0), quad-family
LDG viscosity (method_visc=1) serial + sharded, no-slip walls, kstages 1..4 +
LSRK, and dam/seamount initial conditions. Every StaticConfig branch is now
executed by at least one test.
"""
import functools

import jax
import numpy as np
import pytest

from hnumo_tpu.config import Config
from hnumo_tpu.model import Model
from hnumo_tpu.parallel.sharding import make_mesh


def _bump(**kw):
    base = dict(nelx=8, nely=8, nopx=3, nopy=3, xdims=(0.0, 2e3),
                ydims=(0.0, 2e3), nlayers=2, dt=20.0, dt_btp=2.0,
                time_final=300.0, test_case="bump", dtype="float64")
    base.update(kw)
    return Config(**base)


def _mass(m, s):
    wj = np.asarray(m.g.wjac_df)
    dp = np.asarray(m.P.dpp_ref_df) + np.asarray(s.q_df[0])
    return (wj[None] * dp).sum(axis=(1, 2, 3, 4))


def _run_and_gate(cfg, nsteps=5, mass_tol=1e-12):
    m = Model(cfg)
    s = m.state0
    mass0 = _mass(m, s)
    for _ in range(nsteps):
        s = m.step(s)
    assert bool(s.ok)
    for arr in (s.q_df, s.qb_df, s.qprime_df):
        assert np.all(np.isfinite(np.asarray(arr)))
    mass = _mass(m, s)
    assert np.all(np.abs(mass - mass0) / mass0 < mass_tol)
    return m, s


# ---------------------------------------------------------------------------
# vertical shear stress: implicit tridiagonal solve (ad_mlswe > 0)
# ---------------------------------------------------------------------------

def test_shear_stress_matches_dense_solve():
    """rhs_layer_shear_stress vs an independent dense solve of the same
    tridiagonal system (reference algebra, src/mod_create_rhs_mlswe.F90:
    181-271, including the asymmetric a=-coeff / c=-gravity*dt*coeff
    scaling)."""
    from hnumo_tpu.core.bcl import rhs_layer_shear_stress
    from hnumo_tpu.ops.dg import interp_n2q

    L = 3
    cfg = _bump(test_case="lakeatrest", nlayers=L, ad_mlswe=2.0e-3,
                max_shear_dz=5.0)
    m = Model(cfg)
    P, g, static = m.P, m.g, m.static

    # handcrafted sheared momentum: distinct per-layer velocities
    s = m.state0
    x = np.asarray(m.geom.coord[..., 0])
    dpp_ref = np.asarray(P.dpp_ref_df)
    u_lay = np.stack([(k + 1.0) * 0.1 * (1.0 + 0.3 * np.sin(
        2 * np.pi * x / 2e3)) for k in range(L)])
    v_lay = np.stack([(L - k) * 0.05 * np.ones_like(x) for k in range(L)])
    q_df = np.asarray(s.q_df).copy()
    q_df[1] = u_lay * dpp_ref
    q_df[2] = v_lay * dpp_ref

    out = np.asarray(rhs_layer_shear_stress(static, P, g,
                                            jax.numpy.asarray(q_df)))

    # ---- independent NumPy construction -------------------------------
    grav = static.gravity
    dp = np.asarray(P.dpp_ref_q) + np.asarray(interp_n2q(g, q_df[0]))
    udp = np.asarray(interp_n2q(g, q_df[1]))
    vdp = np.asarray(interp_n2q(g, q_df[2]))
    a1 = float(np.asarray(P.alpha)[0])
    fq = np.asarray(P.coriolis_quad)
    coeff = np.maximum(np.sqrt(0.5 * fq * static.ad_mlswe) / a1,
                       static.ad_mlswe / (a1 * static.max_shear_dz))
    coeff1 = grav * static.dt * coeff

    flat = lambda a: a.reshape(a.shape[0], -1) if a.ndim > 2 else a.reshape(-1)
    dpf, uf, vf = flat(dp), flat(udp), flat(vdp)
    cf, c1f = coeff.reshape(-1), coeff1.reshape(-1)
    npts = dpf.shape[1]
    u_sol = np.zeros((L, npts))
    v_sol = np.zeros((L, npts))
    for i in range(npts):
        M = np.zeros((L, L))
        for k in range(L):
            M[k, k] = dpf[k, i] + (c1f[i] if k in (0, L - 1) else 2 * c1f[i])
            if k > 0:
                M[k, k - 1] = -cf[i]
            if k < L - 1:
                M[k, k + 1] = -c1f[i]
        u_sol[:, i] = np.linalg.solve(M, uf[:, i] / dpf[:, i])
        v_sol[:, i] = np.linalg.solve(M, vf[:, i] / dpf[:, i])

    tau_u = np.zeros((L + 1, npts))
    tau_v = np.zeros((L + 1, npts))
    for k in range(1, L):
        tau_u[k] = cf * (u_sol[k - 1] - u_sol[k])
        tau_v[k] = cf * (v_sol[k - 1] - v_sol[k])
    F_u = grav * (tau_u[:-1] - tau_u[1:]).reshape(dp.shape)
    F_v = grav * (tau_v[:-1] - tau_v[1:]).reshape(dp.shape)

    from hnumo_tpu.ops.dg import scatter_volume
    exp_u = np.asarray(scatter_volume(g, Fs=jax.numpy.asarray(F_u)))
    exp_v = np.asarray(scatter_volume(g, Fs=jax.numpy.asarray(F_v)))
    scale = np.abs(exp_u).max() + 1e-300
    np.testing.assert_allclose(out[0], exp_u, rtol=0, atol=1e-9 * scale)
    np.testing.assert_allclose(out[1], exp_v, rtol=0, atol=1e-9 * scale)


def test_shear_stress_end_to_end():
    """ad_mlswe>0 through the full step: runs, conserves mass, and actually
    changes the answer (the branch is live)."""
    cfg = _bump(ad_mlswe=1.0e-3, max_shear_dz=5.0)
    m1, s1 = _run_and_gate(cfg, nsteps=3)
    m0, s0 = _run_and_gate(_bump(), nsteps=3)
    # branch is live: the (tiny — bump's layers are nearly locked) implicit
    # stress term must perturb the trajectory
    assert not np.array_equal(np.asarray(s1.q_df[1]), np.asarray(s0.q_df[1]))


# ---------------------------------------------------------------------------
# quad-family LDG viscosity (method_visc == 1)
# ---------------------------------------------------------------------------

def test_method_visc1_end_to_end():
    cfg = _bump(method_visc=1, visc_mlswe=5.0)
    m1, s1 = _run_and_gate(cfg, nsteps=3)
    m0, s0 = _run_and_gate(_bump(), nsteps=3)
    assert not np.allclose(np.asarray(s1.q_df[1]), np.asarray(s0.q_df[1]))


def test_method_visc1_sharded_matches_serial():
    cfg = _bump(method_visc=1, visc_mlswe=5.0)
    m1 = Model(cfg)
    s1 = m1.step(m1.state0)
    mesh = make_mesh(jax.devices(), shape=(2, 4))
    mN = Model(cfg, mesh=mesh)
    mass0 = _mass(mN, mN.state0)
    sN = mN.step(mN.state0)
    for name in ("q_df", "qb_df"):
        a, b = np.asarray(getattr(s1, name)), np.asarray(getattr(sN, name))
        for v in range(a.shape[0]):
            scale = max(np.abs(a[v]).max(), 1e-30)
            assert np.abs(a[v] - b[v]).max() / scale < 1e-6, (name, v)
    massN = _mass(mN, sN)
    assert np.all(np.abs(massN - mass0) / mass0 < 1e-12)


# ---------------------------------------------------------------------------
# no-slip walls (BC codes 2 and 5)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("code", [2, 5])
def test_noslip_walls(code):
    cfg = _bump(x_boundary=(code, code), y_boundary=(code, code))
    m, s = _run_and_gate(cfg, nsteps=3)
    # no-slip projection zeroes BOTH momentum components at wall nodes
    q = np.asarray(s.q_df)
    for comp in (1, 2):
        assert np.abs(q[comp][:, :, 0, :, 0]).max() == 0.0   # west
        assert np.abs(q[comp][:, :, -1, :, -1]).max() == 0.0  # east
        assert np.abs(q[comp][:, 0, :, 0, :]).max() == 0.0   # south
        assert np.abs(q[comp][:, -1, :, -1, :]).max() == 0.0  # north
    qb = np.asarray(s.qb_df)
    for comp in (2, 3):
        assert np.abs(qb[comp][:, 0, :, 0]).max() == 0.0
        assert np.abs(qb[comp][:, -1, :, -1]).max() == 0.0


# ---------------------------------------------------------------------------
# barotropic integrator variants
# ---------------------------------------------------------------------------

def _qb_err(s, qb5):
    a, b = np.asarray(s.qb_df), qb5
    return max(np.abs(a[v] - b[v]).max() / max(np.abs(b[v]).max(), 1e-30)
               for v in range(4))


@functools.lru_cache(maxsize=None)
def _ssp53_reference_qb(dtb):
    """SSP(5,3) reference solution shared by all integrator-variant tests
    (one compile instead of one per parametrized case)."""
    m, s = _run_and_gate(_bump(dt_btp=dtb), nsteps=3)
    return np.asarray(s.qb_df)


@pytest.mark.parametrize("kstages", [
    1,
    pytest.param(2, marks=pytest.mark.slow),  # CI covers 1/3/4 every run;
    3,                                        # 2 rides the slow lane
    4,
])
def test_kstages_variants(kstages):
    """All SSPRK variants integrate the same ODE: the deviation from the
    SSP(5,3) reference solution must shrink when dt_btp is halved (true
    convergence, rather than an arbitrary fixed tolerance — forward Euler's
    O(dt) error on the gravity-wave perturbation channel is visibly large)."""
    errs = []
    for dtb in (1.0, 0.5):
        m, s = _run_and_gate(_bump(kstages=kstages, dt_btp=dtb), nsteps=3)
        errs.append(_qb_err(s, _ssp53_reference_qb(dtb)))
    assert errs[1] < 0.75 * errs[0], errs
    # higher-order members stay genuinely close to the reference scheme
    if kstages >= 3:
        assert errs[0] < 1e-2, errs


def test_scan_stages_parity():
    """lax.scan over RK stages vs Python-unrolled stages: identical update
    formulas, so short trajectories must agree to fusion/reassociation
    roundoff (divergence grows with horizon through the 200-substep
    gravity-wave dynamics; 2 steps keeps it near the seed level)."""
    _, s_off = _run_and_gate(_bump(scan_stages="off"), nsteps=2)
    _, s_on = _run_and_gate(_bump(scan_stages="on"), nsteps=2)
    for name in ("qb_df", "q_df", "qprime_df"):
        a = np.asarray(getattr(s_off, name))
        b = np.asarray(getattr(s_on, name))
        scale = np.abs(a).max() + 1e-300
        assert np.abs(a - b).max() / scale < 1e-11, name


def test_lsrk_variant():
    """Correct low-storage Carpenter-Kennedy LSRK5(4): converges to the
    SSP(5,3) reference solution as dt_btp shrinks."""
    errs = []
    for dtb in (1.0, 0.5):
        m, s = _run_and_gate(_bump(ti_method_btp="lsrk", kstages=5,
                                   dt_btp=dtb), nsteps=3)
        errs.append(_qb_err(s, _ssp53_reference_qb(dtb)))
    assert errs[1] < 0.5 * errs[0], errs   # measured ratio ~0.12 (~3rd order)
    assert errs[0] < 5e-3, errs


def test_lsrk_ref_verbatim_diverges():
    """Documents the inherited quirk: the reference applies its 3-register
    SSP update to the LSRK tables (src/mod_rk_mlswe.F90:99-106), which is
    formally inconsistent — state blown up / aborted within 3 steps. Kept
    as 'lsrk_ref' (with a warning) for A/B comparison only."""
    import warnings as _w

    with _w.catch_warnings():
        _w.simplefilter("ignore")
        m = Model(_bump(ti_method_btp="lsrk_ref", kstages=5, dt_btp=1.0))
    s = m.state0
    for _ in range(3):
        s = m.step(s)
    bad = (not bool(s.ok)) or not np.all(np.isfinite(np.asarray(s.qb_df)))
    assert bad, "reference-verbatim LSRK unexpectedly stable"


# ---------------------------------------------------------------------------
# wind-stress vertical distribution: intent mode vs verbatim-reference mode
# (reference slip at src/mod_create_rhs_mlswe.F90:380-382)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compat", [False, True])
def test_wind_stress_distribution(compat):
    """The wind forcing added by layer_momentum_volume equals the analytic
    per-layer distribution g*temp1_k*tau, with temp1 built from the
    cumulative prime pressure (intent) or the reference's verbatim
    accumulator (compat)."""
    import dataclasses

    import jax.numpy as jnp

    from hnumo_tpu.core.bcl import extract_qprime_faces
    from hnumo_tpu.core.bcl import layer_momentum_volume
    from hnumo_tpu.core.btp import barotropic_solve
    from hnumo_tpu.core.coupling import btp_bcl_coeffs
    from hnumo_tpu.ops.dg import interp_n2q, scatter_volume

    cfg = Config(nelx=5, nely=5, nopx=4, nopy=4, xdims=(0.0, 2e6),
                 ydims=(0.0, 2e6), nlayers=2, dt=500.0, dt_btp=25.0,
                 time_final=1e9, test_case="double_gyre", f0=9.3e-5,
                 beta=2e-11, botfr=1, cd_mlswe=1e-7,
                 compat_reference_stress=compat, dtype="float64")
    m = Model(cfg)
    P, g, bc, static = m.P, m.g, m.bc, m.static
    s = m.step(m.state0)  # one step so the primes are nonzero
    qprime_df, q_df = s.qprime_df, s.q_df
    qpf = extract_qprime_faces(bc, qprime_df)
    zq = jnp.zeros_like(interp_n2q(g, qprime_df[0]))
    coup = btp_bcl_coeffs(static, P, g, bc, qprime_df, qpf,
                          qprime_df[0], zq)
    _, avg = barotropic_solve(static, P, g, bc, coup, s.qb_df, qprime_df)

    rhs1 = np.asarray(layer_momentum_volume(static, P, g, avg, qprime_df, q_df))
    P0 = P._replace(tau_wind=jnp.zeros_like(P.tau_wind))
    rhs0 = np.asarray(layer_momentum_volume(static, P0, g, avg, qprime_df, q_df))

    # expected: scatter_volume of Fs = g * temp1_k * tau_wind
    qp0 = np.asarray(interp_n2q(g, qprime_df[0]))
    dpp_full = np.asarray(P.dpp_ref_q) + qp0
    if compat:
        upq = np.asarray(interp_n2q(g, qprime_df[1]))
        comps = np.stack([dpp_full[-1], upq[-1]])
        pl = np.cumsum(comps, axis=0)
        pu = pl - comps
    else:
        pl = np.cumsum(dpp_full, axis=0)
        pu = pl - dpp_full
    Ps = static.Pstress
    temp1 = (np.minimum(pl, Ps) - np.minimum(pu, Ps)) / Ps
    tau = np.asarray(P.tau_wind)
    exp_u = np.asarray(scatter_volume(
        g, Fs=jnp.asarray(static.gravity * temp1 * tau[0][None])))
    exp_v = np.asarray(scatter_volume(
        g, Fs=jnp.asarray(static.gravity * temp1 * tau[1][None])))
    scale = np.abs(exp_u).max()
    np.testing.assert_allclose(rhs1[0] - rhs0[0], exp_u, rtol=0,
                               atol=1e-10 * scale)
    np.testing.assert_allclose(rhs1[1] - rhs0[1], exp_v, rtol=0,
                               atol=1e-10 * scale)
    if not compat:
        # intent mode: a water column deeper than the stress depth absorbs
        # exactly the full wind stress across its layers
        np.testing.assert_allclose(temp1.sum(0), 1.0, rtol=1e-12)


# ---------------------------------------------------------------------------
# dam + seamount initial conditions (reference src/initial_conditions.F90:
# 193-301); smoke runs with the hard mass gate
# ---------------------------------------------------------------------------

def test_seamount_smoke():
    # reference seamount: delta=0.4998 leaves a ~0.8 m bottom layer over the
    # peak — thin but positive, so the standard path applies
    cfg = Config(nelx=8, nely=8, nopx=4, nopy=4,
                 xdims=(0.0, 4.0e5), ydims=(0.0, 4.0e5), nlayers=2,
                 dt=40.0, dt_btp=4.0, time_final=1e9,
                 test_case="seamount", dtype="float64")
    m, s = _run_and_gate(cfg, nsteps=10)
    # seamount at rest is a well-balancedness test: velocities stay ~0
    q = np.asarray(s.q_df)
    dp = np.asarray(m.P.dpp_ref_df) + q[0]
    assert np.abs(q[1:] / dp).max() < 1e-7


# ---------------------------------------------------------------------------
# N-layer configurations (H_face layer-overlap at L > 2;
# reference lakeAtrest supports L >= 5, src/initial_conditions.F90:130-169)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", [4, 10])
def test_lake_at_rest_many_layers(L):
    cfg = _bump(test_case="lakeatrest", nlayers=L, nelx=6, nely=6)
    m, s = _run_and_gate(cfg, nsteps=3)
    # well-balancedness: free surface stays flat over the seamount
    q = np.asarray(s.q_df)
    alpha = np.asarray(m.P.alpha)
    dp = np.asarray(m.P.dpp_ref_df) + q[0]
    h = alpha[:, None, None, None, None] / 9.806 * dp
    ssh = np.asarray(m.P.zbot_df) + h.sum(0)
    assert np.abs(ssh - ssh.mean()).max() < 1e-9
    assert np.abs(q[1:]).max() < 1e-4


def test_many_layers_dynamic():
    """5-layer internal wave over the lakeAtrest seamount: perturb the
    layer-1/2 interface (pb unchanged, so the prime decomposition is exact),
    exercising genuinely multi-layer H_face overlap dynamics; gates:
    stability + per-layer mass conservation."""
    import jax.numpy as jnp

    cfg = _bump(test_case="lakeatrest", nlayers=5, nelx=6, nely=6)
    m = Model(cfg)
    s = m.state0
    x = np.asarray(m.geom.coord[..., 0])
    y = np.asarray(m.geom.coord[..., 1])
    r = np.sqrt((x - 1e3) ** 2 + (y - 1e3) ** 2)
    # interface displacement ~0.5 m as a pressure increment g/alpha * dz
    alpha = np.asarray(m.P.alpha)
    dz = np.where(r < 400.0, 0.25 * (1.0 + np.cos(np.pi * r / 400.0)), 0.0)
    delta = 9.806 / alpha[0] * dz
    q = np.asarray(s.q_df).copy()
    q[0, 0] += delta     # thicken layer 1 ...
    q[0, 1] -= delta     # ... thin layer 2: pb (vertical sum) unchanged
    qp = np.asarray(s.qprime_df).copy()
    qp[0, 0] += delta
    qp[0, 1] -= delta
    s = s._replace(q_df=jnp.asarray(q), qprime_df=jnp.asarray(qp))

    wj = np.asarray(m.g.wjac_df)
    dp0 = np.asarray(m.P.dpp_ref_df) + q[0]
    mass0 = (wj[None] * dp0).sum(axis=(1, 2, 3, 4))
    for _ in range(5):
        s = m.step(s)
    assert bool(s.ok)
    dp = np.asarray(m.P.dpp_ref_df) + np.asarray(s.q_df[0])
    mass = (wj[None] * dp).sum(axis=(1, 2, 3, 4))
    assert np.all(np.abs(mass - mass0) / mass0 < 1e-12)
    # the interface wave must actually propagate (nonzero layer velocities)
    assert np.abs(np.asarray(s.q_df[1:3])).max() > 0.0


# ---------------------------------------------------------------------------
# bc.inp patch reader (reference src/mod_bc.F90:97-221)
# ---------------------------------------------------------------------------

def test_bc_inp_patches(tmp_path):
    from hnumo_tpu.config import config_from_namelist

    nelx, nely = 4, 3
    (tmp_path / "numo3d.in").write_text(
        "&gridnl\n nelx = 4\n nely = 3\n nopx = 3\n nopy = 3\n"
        " xdims = 0.0, 4.0\n ydims = 0.0, 3.0\n nlayers = 2\n/\n"
        "&input\n dt = 1.0\n dt_btp = 0.1\n time_final = 1.0\n"
        " test_case = 'bump'\n lread_bc = .true.\n/\n")
    (tmp_path / "bc.inp").write_text('2\n"west.dat" 2\n"north.dat" 5\n')

    def patch(pts):
        rows = "\n".join(f"{x} {y} 0.0" for x, y in pts)
        return f"header\nheader\n{len(pts)} 1\n{rows}\n"

    west = [(0.0, y) for y in np.linspace(0.0, 3.0, nely + 1)]
    north = [(x, 3.0) for x in np.linspace(0.0, 4.0, nelx + 1)]
    (tmp_path / "west.dat").write_text(patch(west))
    (tmp_path / "north.dat").write_text(patch(north))

    cfg = config_from_namelist(tmp_path / "numo3d.in")
    assert cfg.x_boundary == (2, 4)   # west overridden, east default
    assert cfg.y_boundary == (4, 5)   # north overridden

    # partial-side patch is not representable -> hard error
    (tmp_path / "west.dat").write_text(patch(west[:-1]))
    with pytest.raises(ValueError, match="part of the west side"):
        config_from_namelist(tmp_path / "numo3d.in")


def test_dam_smoke():
    # y-domain limited to the sloping-shelf region: the reference dam
    # geometry produces exactly-zero-thickness layers over the dam crest
    # (z_interface clamped to zbot), which 0/0-faults the velocity split in
    # the reference itself (src/mod_layer_terms.F90:161-163); wetting/drying
    # is out of scope there and here
    cfg = Config(nelx=10, nely=5, nopx=4, nopy=4,
                 xdims=(0.0, 9.0e5), ydims=(0.0, 4.5e5), nlayers=2,
                 dt=30.0, dt_btp=3.0, time_final=1e9,
                 test_case="dam", dtype="float64")
    m, s = _run_and_gate(cfg, nsteps=10)


# ---------------------------------------------------------------------------
# high polynomial order (reference supports arbitrary nop,
# src/mod_basis.F90:84-100); BASELINE.json names p=8 as a bench config
# ---------------------------------------------------------------------------

def test_p8_high_order():
    """p=8 runs stably with a CFL-scaled dt and conserves mass to 1e-12."""
    cfg = _bump(nopx=8, nopy=8, nelx=4, nely=4, dt=5.0, dt_btp=0.5)
    m, s = _run_and_gate(cfg, nsteps=5)
    assert m.g.psiq.shape == (9, 17)  # ngl=9, nq=2*8+1


def test_p8_pallas_interpret_matches_xla():
    """The fused volume kernel handles p=8 shapes (npts=81, nqq=289)."""
    cfg = _bump(nopx=8, nopy=8, nelx=4, nely=4, dt=5.0, dt_btp=0.5)
    m_x = Model(cfg)
    m_p = Model(Config(**{**cfg.__dict__, "use_pallas": "on"}))
    assert m_p.static.use_pallas and m_p.static.pallas_interpret
    s_x = m_x.step(m_x.state0)
    s_p = m_p.step(m_p.state0)
    for name in ("qb_df", "q_df", "qprime_df"):
        a = np.asarray(getattr(s_x, name))
        b = np.asarray(getattr(s_p, name))
        np.testing.assert_allclose(b, a, atol=1e-11 * max(np.abs(a).max(), 1),
                                   err_msg=name)


def test_batched_faces_matches_default():
    """Flat-axis batched face path == per-direction path (same formulas;
    differences bounded by XLA fusion/FMA reassociation, ~1e-14 abs f64)."""
    for extra in ({}, {"method_visc": 2, "visc_mlswe": 5.0}):
        cfg0 = _bump(**extra)
        cfg1 = _bump(batched_faces="on", **extra)
        m0, m1 = Model(cfg0), Model(cfg1)
        assert m1.static.batched_faces
        s0, s1 = m0.state0, m1.state0
        for _ in range(3):
            s0, s1 = m0.step(s0), m1.step(s1)
        for name in ("qb_df", "q_df", "qprime_df"):
            a = np.asarray(getattr(s0, name))
            b = np.asarray(getattr(s1, name))
            np.testing.assert_allclose(
                b, a, atol=1e-11 * max(np.abs(a).max(), 1),
                err_msg=f"{name} {extra}")


def test_debug_checks_flags_nonfinite():
    """debug_checks (SURVEY §5 debug mode): a blow-up run raises
    FloatingPointError/RuntimeError instead of silently producing NaNs; a
    sane run is unaffected."""
    m, s = _run_and_gate(_bump(debug_checks=True), nsteps=2)  # sane: no raise
    bad = Model(_bump(debug_checks=True, dt=2000.0, dt_btp=200.0))
    sb = bad.state0
    with pytest.raises((FloatingPointError, RuntimeError)):
        for _ in range(20):
            sb = bad.step(sb)
            if not bool(sb.ok):
                raise RuntimeError("negative thickness abort")


def test_print_header_banner():
    """Run-config banner (reference src/print_header.F90): contains the key
    config lines and both begin/end variants render."""
    from hnumo_tpu.io.diagnostics import print_header

    m = Model(_bump())
    txt = print_header(m, flag=0, numproc=4)
    assert "Begin Simulation" in txt
    assert "test_case  = bump" in txt
    assert "kstages" in txt and "nlayers npoin nelem nboun" in txt
    assert "numproc =      4" in txt
    assert "End Simulation" in print_header(m, flag=1)
