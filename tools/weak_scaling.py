"""Weak-scaling canary on the fake multi-device CPU backend.

Holds ELEMENTS PER SHARD fixed and grows the mesh (1, 2, 4, 8 virtual CPU
devices), timing the full sharded baroclinic step. On the fake backend the
ppermutes are memcpys, so this measures the COLLECTIVE/PROGRAM overhead the
decomposition adds (halo slicing, edge-shard selects, extra copies) — the
part of the scaling story that can be validated without N real cards; the
latency of the links between cards is not measured by it.
Efficiency = t(1 shard) / t(N shards) at fixed per-shard work; a perfect
program scales at 1.0 on the fake backend (same per-shard FLOPs).

Usage: python tools/weak_scaling.py [--els 16] [--steps 5] [--f32]
Writes one JSON line per mesh.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--els", type=int, default=16,
                    help="elements per shard per axis")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--f32", action="store_true")
    args = ap.parse_args()
    if not args.f32:
        jax.config.update("jax_enable_x64", True)

    from hnumo_tpu import compile_cache
    compile_cache.enable()
    from hnumo_tpu.config import Config
    from hnumo_tpu.model import Model
    from hnumo_tpu.parallel.sharding import make_mesh

    results = []
    # "1s" = serial (no shard_map); "1" = 1-device mesh (the pure
    # decomposition-program overhead, free of core-oversubscription noise —
    # the fake backend shares the host's few cores across all N virtual
    # devices, so the N>1 rows bound program overhead only after dividing
    # out ideal oversubscription t1*N/ncores)
    for nd in ("1s", 1, 2, 4, 8):
        serial = nd == "1s"
        nd = 1 if serial else nd
        devices = jax.devices()[:nd]
        mesh = make_mesh(devices)
        py, px = mesh.shape["y"], mesh.shape["x"]
        nely, nelx = args.els * py, args.els * px
        # double-gyre option set (wind, bottom friction, beta, nodal LDG);
        # dt fixed across rows (same per-shard work; CFL-safe at els*1)
        cfg = Config(nelx=nelx, nely=nely, nopx=4, nopy=4,
                     xdims=(0.0, 2e6 * px), ydims=(0.0, 2e6 * py),
                     nlayers=2, dt=100.0, dt_btp=5.0, time_final=1e9,
                     test_case="double_gyre", f0=9.3e-5, beta=2e-11,
                     botfr=1, cd_mlswe=1e-7, method_visc=3,
                     visc_mlswe=50.0,
                     dtype="float32" if args.f32 else "float64")
        m = Model(cfg, mesh=None if serial else mesh)
        s = m.step(m.state0)
        jax.block_until_ready(s)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            s = m.step(s)
        jax.block_until_ready(s)
        ms = (time.perf_counter() - t0) / args.steps * 1e3
        assert bool(s.ok)
        row = dict(devices=("1-serial" if serial else nd),
                   mesh=("none" if serial else f"{py}x{px}"),
                   grid=f"{nely}x{nelx}",
                   els_per_shard=args.els * args.els,
                   ms_per_step=round(ms, 1))
        if results:
            row["weak_efficiency"] = round(
                results[0]["ms_per_step"] / ms, 3)
        results.append(row)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
