"""Multi-device domain decomposition == single device (rank-count invariance).

The reference's implicit contract: results are independent of the MPI rank
count (SURVEY §4 item 3). XLA compiles the sharded and unsharded programs
differently (different fusion => different floating-point association), and
the MLSWE pressure terms carry ~p^2 ~ 4e10 intermediates, so bitwise
equality is not achievable; observed single-step divergence is ~1e-9
relative to each field's scale (sub-eps per operand). We therefore gate at
1e-6 scale-relative AND check the sharp structural invariants: per-layer
mass conservation at 1e-12 (wrong halo/scatter signs break telescoping
immediately) and lake-at-rest well-balancedness under sharding.
Runs on the fake 8-device CPU backend set up by conftest.py.
"""
import jax
import numpy as np
import pytest

from hnumo_tpu.config import Config
from hnumo_tpu.model import Model
from hnumo_tpu.parallel.sharding import make_mesh


def _cfg(**kw):
    base = dict(nelx=8, nely=8, nopx=3, nopy=3, xdims=(0.0, 2e3), ydims=(0.0, 2e3),
                nlayers=2, dt=20.0, dt_btp=2.0, time_final=300.0,
                test_case="bump", dtype="float64")
    base.update(kw)
    return Config(**base)


def _assert_scaled_close(a, b, tol, name):
    a, b = np.asarray(a), np.asarray(b)
    for v in range(a.shape[0]):
        scale = max(np.abs(a[v]).max(), 1e-30)
        err = np.abs(a[v] - b[v]).max() / scale
        assert err < tol, f"{name}[{v}]: scaled err {err:.3e} >= {tol}"


def _mass(m, s):
    wj = np.asarray(m.g.wjac_df)
    # q_df[0] stores δdp (core.types.State); add the reference thickness
    dp = np.asarray(m.P.dpp_ref_df) + np.asarray(s.q_df[0])
    return (wj[None] * dp).sum(axis=(1, 2, 3, 4))


@pytest.mark.parametrize("shape", [(2, 4), (1, 8)])
def test_sharded_matches_single_device(shape):
    cfg = _cfg()
    m1 = Model(cfg)
    s1 = m1.state0
    for _ in range(3):
        s1 = m1.step(s1)

    mesh = make_mesh(jax.devices()[: shape[0] * shape[1]], shape=shape)
    mN = Model(cfg, mesh=mesh)
    mass0 = _mass(mN, mN.state0)
    sN = mN.state0
    for _ in range(3):
        sN = mN.step(sN)

    _assert_scaled_close(s1.q_df, sN.q_df, 1e-6, "q_df")
    _assert_scaled_close(s1.qb_df, sN.qb_df, 1e-6, "qb_df")
    _assert_scaled_close(s1.qprime_df, sN.qprime_df, 1e-6, "qprime_df")
    assert bool(sN.ok)
    # sharp invariant: per-layer mass conservation under sharding
    massN = _mass(mN, sN)
    assert np.all(np.abs(massN - mass0) / mass0 < 1e-12)


def test_sharded_periodic_and_visc():
    # periodic BCs + viscosity exercise the halo paths of every kernel family
    cfg = _cfg(x_boundary=(3, 3), y_boundary=(4, 4), method_visc=2,
               visc_mlswe=10.0)
    m1 = Model(cfg)
    s1 = m1.step(m1.state0)
    mesh = make_mesh(jax.devices(), shape=(2, 4))
    mN = Model(cfg, mesh=mesh)
    mass0 = _mass(mN, mN.state0)
    sN = mN.step(mN.state0)
    _assert_scaled_close(s1.q_df, sN.q_df, 1e-6, "q_df")
    _assert_scaled_close(s1.qb_df, sN.qb_df, 1e-6, "qb_df")
    massN = _mass(mN, sN)
    assert np.all(np.abs(massN - mass0) / mass0 < 1e-12)


def test_sharded_lake_at_rest():
    # well-balancedness must survive domain decomposition exactly
    cfg = _cfg(test_case="lakeatrest")
    mesh = make_mesh(jax.devices(), shape=(2, 4))
    m = Model(cfg, mesh=mesh)
    s = m.state0
    for _ in range(5):
        s = m.step(s)
    q = np.asarray(s.q_df)
    alpha = np.asarray(m.P.alpha)
    dp = np.asarray(m.P.dpp_ref_df) + q[0]
    h = alpha[:, None, None, None, None] / 9.806 * dp
    ssh = np.asarray(m.P.zbot_df) + h.sum(0)
    assert np.abs(ssh - ssh.mean()).max() < 1e-9
    assert np.abs(q[1:]).max() < 1e-4  # u*dp units: dp~2e5, so u ~ 5e-10 m/s


def test_sharded_batched_faces_matches_serial():
    # flat-axis batched face path (btp._btp_faces_visc_flat): the per-shard
    # [x;y] face concatenation and post-scan split must commute with the
    # halo exchange on every wall/periodic combination exercised here
    cfg = _cfg(x_boundary=(3, 3), y_boundary=(4, 4), method_visc=2,
               visc_mlswe=10.0, batched_faces="on")
    m1 = Model(cfg)
    s1 = m1.step(m1.state0)
    mesh = make_mesh(jax.devices(), shape=(2, 4))
    mN = Model(cfg, mesh=mesh)
    assert mN.static.batched_faces
    mass0 = _mass(mN, mN.state0)
    sN = mN.step(mN.state0)
    _assert_scaled_close(s1.q_df, sN.q_df, 1e-6, "q_df")
    _assert_scaled_close(s1.qb_df, sN.qb_df, 1e-6, "qb_df")
    massN = _mass(mN, sN)
    assert np.all(np.abs(massN - mass0) / mass0 < 1e-12)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (4, 1)])
def test_make_mesh_device_order(shape):
    devs = jax.devices()[:4]
    mesh = make_mesh(devs, shape=shape)
    assert dict(mesh.shape) == {"y": shape[0], "x": shape[1]}
    # row-major in the order given: no topology-driven reordering
    assert list(mesh.devices.flat) == list(devs)


def test_make_mesh_rejects_mismatch():
    with pytest.raises(ValueError, match="mesh shape"):
        make_mesh(jax.devices()[:4], shape=(3, 2))


def test_state_sharding_layout():
    cfg = _cfg()
    mesh = make_mesh(jax.devices(), shape=(2, 4))
    m = Model(cfg, mesh=mesh)
    # element axes of q_df (3, nlayers, ney, nex, ngl, ngl) sharded as (y, x)
    shard_shape = m.state0.q_df.sharding.shard_shape(m.state0.q_df.shape)
    assert shard_shape[2] == cfg.nely // 2 and shard_shape[3] == cfg.nelx // 4
