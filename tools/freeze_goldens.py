"""Freeze float64 CPU trajectory goldens for the regression gate.

Runs short-horizon trajectories of the CI bump case (reference
CI/bump/numo3d.in) and the double-gyre case (reference
Examples/double_gyre/numo3d.in) in float64 on CPU and stores compact state
fingerprints (global min/max/mean/L2 per variable + a strided state sample)
into tests/goldens/*.npz. tests/test_golden.py replays the same
trajectories every suite run and compares (reference hard-fail semantics,
CI/bump/check.F90:58-74).

Usage: python tools/freeze_goldens.py
"""
import os
import sys

import jax
import numpy as np


def force_cpu_f64():
    """Pin the CPU backend + x64 (goldens are f64 CPU by definition).

    Called from __main__, NOT at import: other tools (dgyre_campaign)
    import the config builders from this module and must keep their own
    backend (a module-level pin would silently drag a GPU campaign onto
    the CPU). Importing jax at module scope is safe — only the config
    updates pin a backend."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from hnumo_tpu.config import Config  # noqa: E402
from hnumo_tpu.model import Model  # noqa: E402

OUTDIR = os.path.join(os.path.dirname(__file__), "..", "tests", "goldens")


def fingerprint(state, P):
    """Compact, comparison-friendly fingerprint of a model state."""
    q = np.asarray(jax.device_get(state.q_df), np.float64)
    qb = np.asarray(jax.device_get(state.qb_df), np.float64)
    qp = np.asarray(jax.device_get(state.qprime_df), np.float64)
    out = {}
    for name, a in (("q_df", q), ("qb_df", qb), ("qprime_df", qp)):
        flat = a.reshape(a.shape[0], -1) if a.ndim > 1 else a[None]
        out[f"{name}_min"] = flat.min(axis=1)
        out[f"{name}_max"] = flat.max(axis=1)
        out[f"{name}_mean"] = flat.mean(axis=1)
        out[f"{name}_l2"] = np.sqrt((flat ** 2).mean(axis=1))
        # strided sample pins the full spatial structure, not just extrema
        out[f"{name}_sample"] = flat[:, ::97].copy()
    return out


def bump_config(**kw):
    kw.setdefault("dtype", "float64")
    # goldens pin the UNROLLED stage path bitwise (frozen before
    # scan_stages existed); test_scan_stages_parity bridges the scanned
    # default to it at reassociation-roundoff level
    kw.setdefault("scan_stages", "off")
    return Config(nelx=10, nely=10, nopx=4, nopy=4,
                  xdims=(0.0, 2e3), ydims=(0.0, 2e3), nlayers=2,
                  x_boundary=(4, 4), y_boundary=(4, 4),
                  dt=100.0, dt_btp=1.8, time_final=10800.0,
                  test_case="bump", **kw)


def dgyre_config(**kw):
    # reference Examples/double_gyre/numo3d.in: 25x25, p=4, 2 layers,
    # wind + linear bottom friction + nodal-family viscosity
    kw.setdefault("dtype", "float64")
    kw.setdefault("scan_stages", "off")   # see bump_config
    return Config(nelx=25, nely=25, nopx=4, nopy=4,
                  xdims=(0.0, 2e6), ydims=(0.0, 2e6), nlayers=2,
                  x_boundary=(4, 4), y_boundary=(4, 4),
                  dt=500.0, dt_btp=25.0, time_final=1e9,
                  test_case="double_gyre", f0=0.93e-4, beta=2.0e-11,
                  botfr=1, cd_mlswe=1.0e-7, method_visc=3, visc_mlswe=50.0,
                  **kw)


def freeze(name, cfg, checkpoints):
    m = Model(cfg)
    s = m.state0
    done = 0
    data = {"checkpoints": np.asarray(checkpoints)}
    for nst in checkpoints:
        for _ in range(nst - done):
            s = m.step(s)
        done = nst
        assert bool(s.ok), f"{name}: abort flag at step {nst}"
        for k, v in fingerprint(s, m.P).items():
            data[f"s{nst}_{k}"] = v
    os.makedirs(OUTDIR, exist_ok=True)
    path = os.path.join(OUTDIR, f"{name}.npz")
    np.savez_compressed(path, **data)
    print(f"wrote {path} ({done} steps)")


if __name__ == "__main__":
    force_cpu_f64()
    freeze("bump_traj", bump_config(), [3, 10])
    # 100 dt = ~14 model hours: long enough to pin slow drift in the
    # wind/friction/viscosity wiring, short enough for CI
    freeze("dgyre_traj", dgyre_config(), [3, 10, 50, 100])
