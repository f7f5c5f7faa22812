"""Long-horizon double-gyre campaign.

Runs the reference's flagship wind-driven double-gyre experiment
(Examples/double_gyre/numo3d.in: 25x25 elements, p=4, 2 layers, wind stress
+ linear bottom friction + beta plane + LDG viscosity) for N model days and
records a time series of the reference's own KE diagnostic
(Examples/double_gyre/compute_ke.m: per-layer volume-weighted mean kinetic
energy, scaled by 1e4), SSH extrema, velocity extrema, and relative mass
drift. Where compute_ke.m interpolates to a uniform grid and sums, this
computes the same volume-weighted mean with the DG quadrature itself:

    ke_k = 1e4 * sum(wjac * 0.5*(u_k^2+v_k^2) * h_k) / sum(wjac * h_k)

Writes one JSON artifact per run. A paired f64 run defines the acceptance
band for the f32 production mode (docs/source/test.rst:55-66 judges the
reference on exactly these KE/SSH climatology curves).

Usage:
  python tools/dgyre_campaign.py --days 100 --out docs/artifacts/dgyre_f32_h100.json
  python tools/dgyre_campaign.py --days 100 --f64 --cpu --out docs/artifacts/dgyre_f64_cpu.json
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def sample(model, state):
    """One time-series record from a model state (host-side, numpy)."""
    import numpy as np

    from hnumo_tpu.io.diagnostics import derived_fields
    from hnumo_tpu.parallel.sharding import to_host

    wj = np.asarray(to_host(model.g.wjac_df), np.float64)
    h, u, v, dp, ssh = (np.asarray(a, np.float64)
                        for a in derived_fields(model, state))
    vol = wj[None] * h
    volsum = vol.reshape(vol.shape[0], -1).sum(axis=1)
    s = (0.5 * (u * u + v * v) * vol).reshape(vol.shape[0], -1).sum(axis=1)
    ke_layers = 1e4 * s / volsum
    mass = float(volsum.sum())
    return dict(
        ke=[float(k) for k in ke_layers],
        ke_total=float(ke_layers.sum()),
        mass=mass,
        ssh_max=float(ssh[0].max()), ssh_min=float(ssh[0].min()),
        umax=float(np.abs(u).max()), vmax=float(np.abs(v).max()),
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--days", type=float, default=100.0)
    ap.add_argument("--sample-days", type=float, default=0.5,
                    help="model days between samples")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--nel", type=int, default=25)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax

    from hnumo_tpu.driver import card_line, select_platform
    select_platform(args.cpu)
    if args.f64:
        jax.config.update("jax_enable_x64", True)

    from hnumo_tpu import compile_cache
    compile_cache.enable()
    from hnumo_tpu.model import Model
    from tools.freeze_goldens import dgyre_config

    cfg = dgyre_config(dtype="float64" if args.f64 else "float32")
    if args.nel != 25:
        import dataclasses
        cfg = dataclasses.replace(cfg, nelx=args.nel, nely=args.nel,
                                  dt=500.0 * 25 / args.nel,
                                  dt_btp=25.0 * 25 / args.nel)
    m = Model(cfg)
    dev = jax.devices()[0]
    card = "cpu" if args.cpu else card_line()

    steps_per_sample = max(1, round(args.sample_days * 86400.0 / cfg.dt))
    n_samples = int(round(args.days * 86400.0 / cfg.dt / steps_per_sample))

    s = m.step(m.state0)   # compile + step 1
    jax.block_until_ready(s)
    records = []
    t0 = time.perf_counter()
    done = 1

    def artifact(final):
        wall = time.perf_counter() - t0
        mass0 = records[0]["mass"] if records else float("nan")
        return dict(
            config=dict(nel=args.nel, nop=cfg.nopx, nlayers=cfg.nlayers,
                        dt=cfg.dt, dt_btp=cfg.dt_btp,
                        dtype="float64" if args.f64 else "float32",
                        device=f"{dev.platform} "
                               f"{getattr(dev, 'device_kind', '?')}",
                        card=card),
            days=args.days, steps=done, wall_s=round(wall, 1),
            ms_per_step=round(wall / max(done - 1, 1) * 1e3, 2),
            ok=bool(s.ok), complete=final,
            mass_rel_drift=(max(abs(r["mass"] - mass0) for r in records)
                            / mass0 if records else None),
            records=records,
        )

    def write(final=False):
        # incremental write: a partial (interrupted) campaign still leaves
        # a usable artifact with everything sampled so far
        text = json.dumps(artifact(final))
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            tmp = args.out + ".tmp"
            with open(tmp, "w") as f:
                f.write(text)
            os.replace(tmp, args.out)
        elif final:
            print(text)

    for i in range(n_samples):
        target = (i + 1) * steps_per_sample
        while done < target:
            s = m.step(s)
            done += 1
        jax.block_until_ready(s)
        if not bool(s.ok):
            print(f"ABORT at step {done} (negative thickness / nonfinite)",
                  file=sys.stderr)
            break
        rec = sample(m, s)
        rec["step"] = done
        rec["t_days"] = done * cfg.dt / 86400.0
        records.append(rec)
        print(f"day {rec['t_days']:7.2f}  KE {rec['ke_total']:.6f} "
              f"(l1 {rec['ke'][0]:.6f} l2 {rec['ke'][1]:.6f})  "
              f"ssh [{rec['ssh_min']:+.3f},{rec['ssh_max']:+.3f}]  "
              f"|u|max {rec['umax']:.4f}", file=sys.stderr)
        write(final=False)
    write(final=True)
    if args.out:
        print(f"wrote {args.out} ({done} steps, "
              f"{time.perf_counter() - t0:.0f}s)", file=sys.stderr)


if __name__ == "__main__":
    main()
