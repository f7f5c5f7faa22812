"""Run driver: time loop with periodic snapshots/diagnostics + restart + CLI.

Replaces the reference runtime layer (src/amain.F90:12-73,
src/mod_time_loop.F90:26-285): snapshot-0 write, restart branch,
conservation baseline, the while(time < time_final) loop with periodic
output, RHS timing accumulation dumped to time.csv, and the final
mlswe_FIN.txt summary (the CI golden-file contract).

CLI:  python -m hnumo_tpu <numo3d.in> [--outdir DIR] [--mesh PYxPX] ...
"""
from __future__ import annotations

import os
import time as _time

import jax

from .io import diagnostics as diag
from .io import snapshots as snap


class Runner:
    def __init__(self, model, outdir="."):
        self.model = model
        self.outdir = outdir
        os.makedirs(outdir, exist_ok=True)
        cfg = model.cfg
        # absolute step count (reference ntime=ceiling(time_final/dt),
        # src/mod_time_loop.F90:63; restart resumes at itime=irestart_file_number)
        import math
        self.ntime = math.ceil(cfg.t_final / cfg.dt)
        self.irestart = max(1, round(cfg.t_restart / cfg.dt))
        self.rhs_time = 0.0
        self.mass0 = None

    def _write_snapshot(self, state, itime):
        cfg = self.model.cfg
        if not cfg.dump_data:
            return
        if cfg.out_type == "nc":
            snap.write_nc(self.model, state, itime, outdir=self.outdir)
        elif cfg.out_type == "vtk":
            from .io.vtk import write_vtk

            write_vtk(self.model, state, itime, outdir=self.outdir,
                      fmt=cfg.format_vtk)
            # restart needs a readable prognostic snapshot alongside VTK
            snap.write_txt(self.model, state, itime, outdir=self.outdir)
        else:
            snap.write_txt(self.model, state, itime, outdir=self.outdir)

    def run(self, state=None, quiet=False):
        m = self.model
        cfg = m.cfg
        itime = 0
        nproc = 1 if m.mesh is None else m.mesh.devices.size
        if not quiet:
            # run-config banner (reference src/print_header.F90)
            print(diag.print_header(m, flag=0, numproc=nproc))

        if state is None:
            if cfg.time_initial > 0:
                # restart branch (reference src/mod_time_loop.F90:122-148)
                itime = cfg.irestart_file_number
                ext = ".nc" if cfg.out_type == "nc" else ""
                path = os.path.join(self.outdir, f"mlswe{itime:04d}{ext}")
                data = snap.read_nc(path) if cfg.out_type == "nc" else snap.read_txt(path)
                state = snap.restore_state(m, data, t=cfg.t_initial)
            else:
                state = m.state0
                self._write_snapshot(state, 0)

        self.mass0 = diag.compute_mass(m, state)
        mass_log = open(os.path.join(self.outdir, "mass_mlswe.cons"), "a")

        t_wall0 = _time.perf_counter()
        while itime < self.ntime:
            itime += 1
            t0 = _time.perf_counter()
            state = m.step(state)
            if not bool(state.ok):   # forces sync, matching reference fail-stop
                raise RuntimeError(
                    f"Negative mass in thickness (itime={itime}) — aborting, "
                    "as the reference does (src/mod_splitting.F90:74-77)")
            self.rhs_time += _time.perf_counter() - t0

            if itime % self.irestart == 0 or itime == self.ntime:
                self._write_snapshot(state, itime)
                s = diag.summary(m, state, self.mass0)
                mass_log.write(f"{itime:8d} " +
                               " ".join(f"{v:24.16e}" for v in s["mass"]) + "\n")
                if cfg.lprint_diagnostics and not quiet:
                    print(diag.print_summary(s, itime, cfg.dt, cfg.dt_btp_eff,
                                             cfg.time_scale))

        wall = _time.perf_counter() - t_wall0
        mass_log.close()

        # final summary + FIN file (reference print_diagnostics idone=1 path)
        s = diag.summary(m, state, self.mass0)
        diag.write_fin(os.path.join(self.outdir, "mlswe_FIN.txt"), s)
        with open(os.path.join(self.outdir, "time.csv"), "a") as f:
            f.write(f"{self.rhs_time:.6f}, {wall:.6f}\n")
        if not quiet:
            print(" **Simulation Finished**")
            print(f"steps={itime} wall={wall:.2f}s rhs_time={self.rhs_time:.2f}s")
            print(diag.print_header(m, flag=1, numproc=nproc))
        return state, s


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def select_platform(cpu: bool) -> None:
    """Run on the CPU when asked; otherwise insist on a GPU.

    Entry points call this before any JAX work, so a machine whose GPU is
    missing fails loudly instead of quietly running on the CPU."""
    if cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        jax.config.update("jax_platforms", "cpu")
        return
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise RuntimeError(f"no GPU found (JAX platform is {platform!r}); "
                           "pass --cpu to run on the CPU")


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(prog="hnumo_tpu",
                                description="Multilayer SWE DG solver")
    p.add_argument("input", help="numo3d.in namelist file")
    p.add_argument("--outdir", default=".")
    p.add_argument("--mesh", default=None,
                   help="PYxPX device mesh, e.g. 2x4 (default: single device)")
    p.add_argument("--f32", action="store_true", help="run in float32")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: fail unless a GPU is found)")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)

    select_platform(args.cpu)

    from . import compile_cache
    compile_cache.enable()

    from .config import config_from_namelist
    from .model import Model

    overrides = {}
    if args.f32:
        overrides["dtype"] = "float32"
    cfg = config_from_namelist(args.input, **overrides)

    mesh = None
    if args.mesh:
        from .parallel.sharding import make_mesh

        py, px = (int(v) for v in args.mesh.lower().split("x"))
        mesh = make_mesh(jax.devices()[: py * px], shape=(py, px))

    model = Model(cfg, mesh=mesh)
    runner = Runner(model, outdir=args.outdir)
    runner.run(quiet=args.quiet)


if __name__ == "__main__":
    main()
