"""Scanned vs unrolled RK stages of the barotropic sub-cycle.

scan_stages runs the kstages stages as one lax.scan body; off, they are
Python-unrolled into the sub-cycling scan. Same update formulas, so the
final barotropic state AND every one of the 23 running averages (the
baroclinic step consumes them all) must agree to reassociation roundoff."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hnumo_tpu.config import Config
from hnumo_tpu.model import Model


def _cfg(visc, botfr=1, kstages=5, nop=4, **over):
    kw = dict(method_visc=2, visc_mlswe=100.0) if visc else dict(
        method_visc=0, visc_mlswe=0.0)
    kw.update(over)
    return Config(nelx=6, nely=5, nopx=nop, nopy=nop, xdims=(0.0, 2e6),
                  ydims=(0.0, 2e6), nlayers=2, dt=400.0, dt_btp=20.0,
                  time_final=1e9, test_case="double_gyre", f0=9.3e-5,
                  beta=2e-11, botfr=botfr, cd_mlswe=1e-7, kstages=kstages,
                  dtype="float64", **kw)


def _perturbed_inputs(m, seed=0):
    from hnumo_tpu.core.bcl import extract_qprime_faces
    from hnumo_tpu.core.coupling import btp_bcl_coeffs
    from hnumo_tpu.ops.dg import interp_n2q

    rng = np.random.default_rng(seed)
    s = m.state0
    qb = s.qb_df + jnp.asarray(
        1e-3 * np.abs(rng.normal(size=s.qb_df.shape)), m.dtype)
    qp = s.qprime_df + jnp.asarray(
        1e-4 * rng.normal(size=s.qprime_df.shape), m.dtype)
    qpf = extract_qprime_faces(m.bc, qp)
    zq = jnp.zeros_like(interp_n2q(m.g, qp[0]))
    coup = btp_bcl_coeffs(m.static, m.P, m.g, m.bc, qp, qpf, qp[0], zq)
    return qb, qp, coup


def _flatten_avg(avg):
    out = {}
    for name, v in zip(avg._fields, avg):
        if name == "faces":
            for d, fa in zip(("x", "y"), v):
                for fn, fv in zip(fa._fields, fa):
                    out[f"faces.{d}.{fn}"] = np.asarray(fv, np.float64)
        else:
            out[name] = np.asarray(v, np.float64)
    return out


@pytest.mark.parametrize("visc,botfr,kstages,nop", [
    (False, 1, 5, 4),
    (True, 1, 5, 4),
    (True, 2, 5, 4),     # quadratic bottom drag branch
    (False, 0, 3, 4),    # no drag + SSP(3,3) tables (no qb2 snapshot)
    (True, 1, 5, 6),     # higher order
])
def test_solve_scan_parity(visc, botfr, kstages, nop):
    from hnumo_tpu.core.btp import barotropic_solve

    m = Model(_cfg(visc, botfr=botfr, kstages=kstages, nop=nop))
    qb, qp, coup = _perturbed_inputs(m)

    def solve(scan):
        st = dataclasses.replace(m.static, scan_stages=scan)
        return jax.jit(lambda qb_, qp_: barotropic_solve(
            st, m.P, m.g, m.bc, coup, qb_, qp_))(qb, qp)

    qb_scan, avg_scan = solve(True)
    qb_unr, avg_unr = solve(False)
    np.testing.assert_allclose(np.asarray(qb_scan), np.asarray(qb_unr),
                               rtol=1e-11, atol=1e-11, err_msg="qb")
    ref = _flatten_avg(avg_unr)
    got = _flatten_avg(avg_scan)
    for name in ref:
        scale = np.abs(ref[name]).max() + 1e-30
        np.testing.assert_allclose(
            got[name] / scale, ref[name] / scale, rtol=0, atol=1e-11,
            err_msg=f"average {name}")


def test_full_steps_scan_parity():
    """Two full baroclinic steps of the viscous double gyre."""
    m_on = Model(_cfg(True, scan_stages="on"))
    m_off = Model(_cfg(True, scan_stages="off"))
    assert m_on.static.scan_stages and not m_off.static.scan_stages
    s_on, s_off = m_on.state0, m_off.state0
    for _ in range(2):
        s_on = m_on.step(s_on)
        s_off = m_off.step(s_off)
    assert bool(s_on.ok)
    for name in ("qb_df", "q_df", "qprime_df"):
        a = np.asarray(getattr(s_on, name), np.float64)
        b = np.asarray(getattr(s_off, name), np.float64)
        scale = np.abs(b).max() + 1e-30
        assert np.abs(a - b).max() / scale < 1e-10, name
