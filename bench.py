"""Benchmark: DG grid-points/s per chip for the full MLSWE step.

Runs a double-gyre-scale configuration (p=4, 2 layers, N_btp=20 x 5-stage
SSPRK x 2 barotropic solves per baroclinic dt — the reference's production
sub-cycling intensity, Examples/double_gyre/numo3d.in:25-26,53) on the
GPU in float32 (within the reference's own -DSINGLE design envelope,
src/mod_types.F90:19-22). Without a GPU it fails unless --cpu is given.

Prints ONE JSON line:
  {"metric": "dg_gridpoint_steps_per_s", "value": N, "unit": "...", "vs_baseline": N}

grid-points = nelem * nq^2 * nlayers (BASELINE.md); value = grid-points *
baroclinic-steps / wall-second. vs_baseline compares against this
framework's own float64 CPU single-core throughput on the reference's CI
bump config measured in round 1 (28.4e3 gp-steps/s; the reference repo
publishes no absolute numbers — BASELINE.md), i.e. the speedup of one
card over the serial validation build.
"""
import argparse
import json
import sys
import time

BASELINE_GPS = 28.4e3  # f64 CPU single-core, CI bump config (see docstring)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--nel", type=int, default=32, help="elements per side")
    p.add_argument("--nop", type=int, default=4)
    p.add_argument("--nlayers", type=int, default=2)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--f64", action="store_true")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args()

    import os

    import jax

    from hnumo_tpu.driver import card_line, select_platform
    select_platform(args.cpu)
    card = "cpu" if args.cpu else card_line()

    from hnumo_tpu import compile_cache
    compile_cache.enable()

    from hnumo_tpu.config import Config
    from hnumo_tpu.model import Model

    # double-gyre-like basin (reference Examples/double_gyre/numo3d.in):
    # 2000 km x 2000 km, wind-driven, beta plane; dt chosen for CFL at this
    # resolution (reference uses dt=500/dt_btp=25 at 25x25 elements p=4)
    nel = args.nel
    # CFL: the stable dt scales with the minimum node spacing, which is
    # (domain/nel) * (min LGL gap) with min LGL gap ~ 1/p^2; the reference
    # anchor (dt=500, dt_btp=25) is at 25x25 elements, p=4
    scale = (25.0 / nel) * (4.0 / args.nop) ** 2
    cfg = Config(
        nelx=nel, nely=nel, nopx=args.nop, nopy=args.nop,
        xdims=(0.0, 2.0e6), ydims=(0.0, 2.0e6), nlayers=args.nlayers,
        dt=500.0 * scale, dt_btp=25.0 * scale, time_final=1e9,
        test_case="double_gyre", f0=9.3e-5, beta=2.0e-11,
        botfr=1, cd_mlswe=1.0e-7, method_visc=2, visc_mlswe=100.0,
        dtype="float64" if args.f64 else "float32",
    )
    # bench hygiene: a loaded host contaminates dispatch-sensitive device
    # numbers — warn loudly if anything else is burning CPU in the
    # measurement window
    try:
        load1 = os.getloadavg()[0]
        ncpu = os.cpu_count() or 1
        if load1 > 0.5 * ncpu:
            print(f"# WARNING: host load average {load1:.2f} on {ncpu} CPUs "
                  "— concurrent work will contaminate this benchmark",
                  file=sys.stderr)
    except OSError:
        pass

    m = Model(cfg)
    dev = jax.devices()[0]
    t_c0 = time.perf_counter()
    s = m.step(m.state0)          # compile + warm
    jax.block_until_ready(s)
    compile_s = time.perf_counter() - t_c0
    s = m.step(s)
    jax.block_until_ready(s)

    t0 = time.perf_counter()
    for _ in range(args.steps):
        s = m.step(s)
    jax.block_until_ready(s)
    dt_wall = time.perf_counter() - t0

    nq = 2 * args.nop + 1
    gp = nel * nel * nq * nq * args.nlayers
    gps = gp * args.steps / dt_wall
    n_rhs = 2 * m.static.n_btp * m.static.kstages
    print(f"# device={dev.platform} {getattr(dev, 'device_kind', '?')} "
          f"grid={nel}x{nel} p={args.nop} L={args.nlayers} "
          f"N_btp={m.static.n_btp} ({n_rhs} btp RHS/dt) "
          f"dtype={cfg.dtype}: {dt_wall/args.steps*1e3:.1f} ms/step, "
          f"compile+step1={compile_s:.1f}s, ok={bool(s.ok)} [{card}]",
          file=sys.stderr)
    print(json.dumps({
        "metric": "dg_gridpoint_steps_per_s",
        "value": round(gps, 1),
        "unit": "grid-points*baroclinic-steps/s/card",
        "vs_baseline": round(gps / BASELINE_GPS, 2),
    }))


if __name__ == "__main__":
    main()
