"""Smoke check of the solver's served path on one GPU.

Runs in one process, phase after phase, and exits non-zero if any phase
fails, if JAX finds no GPU, or if the package is not importable next to
this file:

  A. device: platform, device kind, JAX version, XLA_FLAGS, card name and
     power limit;
  B. the frozen f64 golden trajectories (tests/goldens) replayed on the card;
  C. driver.Runner on the reference double gyre (25x25 elements, p=4, two
     layers, dt=500 s, 200 barotropic RHS per step) for one model day in
     f64 and f32, with snapshots and diagnostics on: mass drift and the
     f32-vs-f64 kinetic energy;
  D. the fused volume kernel (ops/pallas_btp.py), compiled through Triton,
     against the XLA volume path at 25x25 and 128x128 (p=4) and 32x32 (p=8),
     the stage timed at p=4, and Model.step timed at 25x25 with the kernel
     on and off;
  E. (--multi, four cards; runs alone) the double gyre at 32x32 elements on
     a 2x2 device mesh against the single-card run, f64 and f32.

The last line of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Usage:  python chip_smoke.py            # phases A-D, one card
        python chip_smoke.py --multi    # phase E, four cards
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

GOLDEN_RTOL = 1e-9
KERNEL_TOL = 1e-5
DAY_STEPS = 173               # ceil(86400 s / 500 s)


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def phase_device(n_cards: int):
    import jax

    from hnumo_tpu.driver import card_line

    devs = jax.devices()
    d = devs[0]
    check(d.platform == "gpu", f"no GPU: jax.devices()[0] is {d.platform}")
    check(len(devs) >= n_cards, f"need {n_cards} GPUs, found {len(devs)}")
    card = card_line()
    print(f"[A] device_kind={d.device_kind} count={len(devs)} "
          f"jax={jax.__version__} XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"[A] card: {card}")
    return card


def _sync(s):
    import jax

    jax.block_until_ready(s)
    return s


# ---------------------------------------------------------------- phase B

def phase_goldens():
    import numpy as np

    from hnumo_tpu.model import Model
    from tools.freeze_goldens import bump_config, dgyre_config, fingerprint

    worst_all = 0.0
    for name, cfg, max_steps in (("bump_traj", bump_config(), None),
                                 ("dgyre_traj", dgyre_config(), 10)):
        g = np.load(os.path.join(ROOT, "tests", "goldens", f"{name}.npz"))
        checkpoints = [int(c) for c in g["checkpoints"]
                       if max_steps is None or c <= max_steps]
        m = Model(cfg)
        s, done, worst = m.state0, 0, 0.0
        for nst in checkpoints:
            for _ in range(nst - done):
                s = m.step(s)
            done = nst
            check(bool(s.ok), f"{name}: abort flag at step {nst}")
            for key, val in fingerprint(s, m.P).items():
                ref = g[f"s{nst}_{key}"]
                var = key.rsplit("_", 1)[0]
                atol = 1e-13 * (np.max(np.abs(g[f"s{nst}_{var}_max"]))
                                + 1e-300)
                # smallest rtol for which tests/test_golden.py's
                # assert_allclose(val, ref, rtol, atol) holds
                excess = np.maximum(np.abs(val - ref) - atol, 0.0)
                worst = max(worst, float(np.max(
                    excess / np.maximum(np.abs(ref), 1e-300))))
        print(f"[B] {name}: {done} steps f64, smallest rtol that holds "
              f"{worst:.3e} (target {GOLDEN_RTOL:.0e})")
        worst_all = max(worst_all, worst)
    check(worst_all <= GOLDEN_RTOL,
          f"goldens deviate: rtol {worst_all:.3e} > {GOLDEN_RTOL:.0e}")


# ---------------------------------------------------------------- phase C

def _run_day(dtype: str, card: str):
    import dataclasses

    import jax

    from hnumo_tpu.driver import Runner
    from hnumo_tpu.model import Model
    from tools.dgyre_campaign import sample
    from tools.freeze_goldens import dgyre_config

    cfg = dataclasses.replace(
        dgyre_config(dtype=dtype, scan_stages="auto"),
        time_final=DAY_STEPS * 500.0, time_restart=43 * 500.0,
        dump_data=True, lprint_diagnostics=True)
    m = Model(cfg)
    t0 = time.perf_counter()
    _sync(m.step(m.state0))               # compile (the Runner reuses it)
    compile_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as out:
        runner = Runner(m, outdir=out)
        state, summ = runner.run(quiet=True)
        nsnap = len([f for f in os.listdir(out) if f.startswith("mlswe0")])
    check(bool(state.ok), f"{dtype}: abort flag set")
    mass0, mass = sum(runner.mass0), sum(summ["mass"])
    drift = abs(mass - mass0) / mass0
    ms = runner.rhs_time / runner.ntime * 1e3
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    ke = sample(m, state)["ke_total"]
    print(f"[C] {dtype}: {runner.ntime} steps, {ms:.3f} ms/step, compile "
          f"{compile_s:.1f} s, peak_bytes_in_use {peak}, mass drift "
          f"{drift:.3e}, KE {ke:.6f}, {nsnap} snapshots, "
          f"use_pallas={m.static.use_pallas} "
          f"scan_stages={m.static.scan_stages} [{card}]")
    return drift, ke


def phase_main_path(card: str):
    d64, ke64 = _run_day("float64", card)
    d32, ke32 = _run_day("float32", card)
    check(d64 < 1e-12, f"f64 mass drift {d64:.3e} >= 1e-12")
    check(d32 < 1e-5, f"f32 mass drift {d32:.3e} >= 1e-5")
    rel = abs(ke32 - ke64) / abs(ke64)
    print(f"[C] f32 vs f64 KE after one day: rel {rel:.3e} (limit 2e-2)")
    check(rel < 0.02, f"f32 KE off f64 by {rel:.3e}")


# ---------------------------------------------------------------- phase D

def _dgyre(nel: int, nop: int, dtype="float32", **kw):
    from hnumo_tpu.config import Config

    # the reference basin; dt scaled by CFL from its 25x25 p=4 anchor
    scale = (25.0 / nel) * (4.0 / nop) ** 2
    return Config(nelx=nel, nely=nel, nopx=nop, nopy=nop,
                  xdims=(0.0, 2e6), ydims=(0.0, 2e6), nlayers=2,
                  dt=500.0 * scale, dt_btp=25.0 * scale, time_final=1e9,
                  test_case="double_gyre", f0=0.93e-4, beta=2.0e-11,
                  botfr=1, cd_mlswe=1.0e-7, method_visc=3, visc_mlswe=50.0,
                  dtype=dtype, **kw)


def _kernel_inputs(m, seed=0):
    import jax.numpy as jnp
    import numpy as np

    from hnumo_tpu.core.bcl import extract_qprime_faces
    from hnumo_tpu.core.coupling import btp_bcl_coeffs
    from hnumo_tpu.ops.dg import interp_n2q

    rng = np.random.default_rng(seed)
    s = m.state0
    qb = s.qb_df + jnp.asarray(1e-3 * np.abs(rng.normal(size=s.qb_df.shape)),
                               m.dtype)
    qp = s.qprime_df + jnp.asarray(
        1e-4 * rng.normal(size=s.qprime_df.shape), m.dtype)
    qpf = extract_qprime_faces(m.bc, qp)
    zq = jnp.zeros_like(interp_n2q(m.g, qp[0]))
    coup = btp_bcl_coeffs(m.static, m.P, m.g, m.bc, qp, qpf, qp[0], zq)
    qpl_q = interp_n2q(m.g, qp[:, -1])
    return qb, coup, qpl_q


def _time_loop(stage, args, iters):
    """Mean seconds per stage of `iters` stages run in one jitted loop.

    Each iteration feeds its RHS back into the state, so XLA can neither
    drop the RHS nor hoist the loop-invariant work out of the loop."""
    import jax

    def body(i, c):
        qb, accv, accn = c
        rhs, accv, accn = stage(qb, accv, accn)
        return qb.at[1:].add(1e-12 * rhs), accv, accn

    loop = jax.jit(lambda *a: jax.lax.fori_loop(0, iters, body, a))
    _sync(loop(*args))
    t0 = time.perf_counter()
    _sync(loop(*args))
    return (time.perf_counter() - t0) / iters


def kernel_check(nel: int, nop: int, card: str, iters=200, timed=True):
    """Compiled kernel vs the XLA volume path; returns (max rel err,
    {path: seconds per stage}), timings only if `timed`."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hnumo_tpu.core.btp import btp_volume_rhs
    from hnumo_tpu.model import Model
    from hnumo_tpu.ops.pallas_btp import btp_volume_pallas, operators

    m = Model(_dgyre(nel, nop, use_pallas="off"))
    st, P, g = m.static, m.P, m.g
    qb, coup, qpl_q = _kernel_inputs(m)
    rng = np.random.default_rng(1)
    nq, ngl = g.wjac.shape[-1], g.wjac_df.shape[-1]
    accv0 = jnp.asarray(rng.normal(size=(12, nel, nel, nq, nq)), m.dtype)
    accn0 = jnp.asarray(rng.normal(size=(3, nel, nel, ngl, ngl)), m.dtype)
    ops = operators(g.psiq, g.dpsiq)
    kw = dict(grav=st.gravity, botfr=st.botfr, cd=st.cd_mlswe,
              alpha_bot=st.alpha_bot)

    def xla_stage(qb_, accv, accn):
        t_df = qb_[1] * P.one_over_pbprime_df
        incn = jnp.stack([t_df * (2.0 + t_df), qb_[2] / qb_[0],
                          qb_[3] / qb_[0]])
        rhs, vinc = btp_volume_rhs(st, P, g, coup, qb_, qpl_q)
        return rhs, accv + vinc, accn + incn

    def f(qb_, accv, accn):     # the kernel's stage
        return btp_volume_pallas(ops, g, P, coup, qb_, qpl_q, accv, accn, **kw)

    ref = jax.jit(xla_stage)(qb, accv0, accn0)
    out = jax.jit(f)(qb, accv0, accn0)
    errs = [float(jnp.max(jnp.abs(a - b)) / jnp.max(jnp.abs(b)))
            for a, b in zip(out, ref)]
    worst = max(errs)
    print(f"[D] kernel {nel}x{nel} p={nop}: max err / field max rhs "
          f"{errs[0]:.2e} accv {errs[1]:.2e} accn {errs[2]:.2e} "
          f"(precision HIGHEST, f32)")
    if not timed:
        return worst, {}
    times = {"pallas": _time_loop(f, (qb, accv0, accn0), iters),
             "xla": _time_loop(xla_stage, (qb, accv0, accn0), iters)}
    print(f"[D] stage volume {nel}x{nel} p={nop}: " + ", ".join(
        f"{k} {v * 1e6:.2f} us" for k, v in times.items()) + f" [{card}]")
    return worst, times


def step_time(cfg, nsteps):
    """(ms per Model.step, compile s) after a compile and one warm step."""
    from hnumo_tpu.model import Model

    m = Model(cfg)
    t0 = time.perf_counter()
    s = _sync(m.step(m.state0))
    compile_s = time.perf_counter() - t0
    s = _sync(m.step(s))
    t0 = time.perf_counter()
    for _ in range(nsteps):
        s = m.step(s)
    _sync(s)
    ms = (time.perf_counter() - t0) / nsteps * 1e3
    check(bool(s.ok), "abort flag in timed run")
    return ms, compile_s, m.static


def phase_kernel(card: str):
    worst = 0.0
    # p=8 is checked, not timed: the kernel loses there (docs/performance.md)
    # and each of its compiles takes minutes
    for nel, nop, timed in ((25, 4, True), (128, 4, True), (32, 8, False)):
        w, _ = kernel_check(nel, nop, card, timed=timed)
        worst = max(worst, w)
    check(worst <= KERNEL_TOL, f"kernel error {worst:.2e} > {KERNEL_TOL}")
    for pallas in ("off", "on"):
        ms, cs, st = step_time(_dgyre(25, 4, use_pallas=pallas), 20)
        print(f"[D] Model.step 25x25 p=4 f32 use_pallas={pallas} "
              f"(scan_stages={st.scan_stages}): {ms:.3f} ms/step, "
              f"compile {cs:.1f} s [{card}]")


# ---------------------------------------------------------------- phase E

def phase_multi(card: str):
    import jax
    import numpy as np

    from hnumo_tpu.model import Model
    from hnumo_tpu.parallel.sharding import make_mesh

    from hnumo_tpu.io.diagnostics import compute_mass

    mesh = make_mesh(jax.devices()[:4], shape=(2, 2))
    names = ("qb_df", "q_df", "qprime_df")

    def scaled_errs(s, ref):
        """Per (field, channel): max |s - ref| over max |ref|."""
        out = []
        for name in names:
            a = np.asarray(getattr(s, name), np.float64)
            for v in range(a.shape[0]):
                r = ref[name][v]
                out.append(float(np.abs(a[v] - r).max()
                                 / max(np.abs(r).max(), 1e-30)))
        return np.asarray(out)

    # The sharded and single-card programs fuse and sum in different orders,
    # so they agree to roundoff grown over 10 steps x 200 barotropic stages,
    # not bitwise: f64 scaled error ~3e-12 on virtual CPU devices, hence the
    # 1e-10 limit. In f32 the layer fields are still noise-sized 10 steps
    # from rest (the single-card f32 run is 10-50% off f64 in them), so the
    # f32 sharded run is held to the single-card f32 run's own distance
    # from f64, within 25%. The sharp check in both is per-layer mass
    # conservation of the sharded run.
    models = {dt: (Model(_dgyre(32, 4, dtype=dt)),
                   Model(_dgyre(32, 4, dtype=dt), mesh=mesh))
              for dt in ("float64", "float32")}
    # compile the four steps concurrently (XLA compiles outside the GIL)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        list(pool.map(lambda m: _sync(m.step(m.state0)),
                      [m for pair in models.values() for m in pair]))
    print(f"[E] four steps compiled in {time.perf_counter() - t0:.1f} s")
    ref = None
    for dtype, mtol in (("float64", 1e-12), ("float32", 1e-5)):
        m1, mN = models[dtype]
        s1, sN = m1.state0, mN.state0
        mass0 = compute_mass(mN, sN)
        t0 = time.perf_counter()
        for _ in range(10):
            s1 = m1.step(s1)
            sN = mN.step(sN)
        _sync((s1, sN))
        check(bool(s1.ok) and bool(sN.ok), f"{dtype}: abort flag")
        dm = float(np.max(np.abs(compute_mass(mN, sN) - mass0) / mass0))
        if ref is None:
            ref = {n: np.asarray(getattr(s1, n), np.float64) for n in names}
            worst = float(scaled_errs(sN, ref).max())
            verdict = f"max scaled err vs one card {worst:.3e} (limit 1e-10)"
            ok = worst < 1e-10
        else:
            e1, eN = scaled_errs(s1, ref), scaled_errs(sN, ref)
            ratio = float(np.max(eN / np.maximum(e1, 1e-6)))
            verdict = (f"scaled err vs f64: one card max {e1.max():.3e}, "
                       f"mesh max {eN.max():.3e}, worst mesh/one-card "
                       f"ratio {ratio:.3f} (limit 1.25)")
            ok = ratio < 1.25
        print(f"[E] 32x32 p=4 {dtype}, 10 steps, 2x2 mesh: {verdict}; "
              f"sharded layer mass drift {dm:.3e} (limit {mtol:.0e}); "
              f"{time.perf_counter() - t0:.1f} s for 10+10 steps [{card}]")
        check(ok, f"{dtype} sharded run deviates: {verdict}")
        check(dm < mtol, f"{dtype} sharded mass drift {dm:.3e}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card mesh phase (E)")
    args = ap.parse_args(argv)
    n_cards = 4 if args.multi else 1

    from hnumo_tpu import compile_cache

    compile_cache.enable()
    import jax

    try:
        card = phase_device(n_cards)
        if args.multi:
            phase_multi(card)
        else:
            phase_goldens()
            phase_main_path(card)
            phase_kernel(card)
    except PhaseError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    d = jax.devices()[0]
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
