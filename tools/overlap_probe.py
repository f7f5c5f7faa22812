"""Comm/compute overlap measurement on the fake 8-device CPU mesh.

Measures the sharded-vs-serial full-step time ratio at fixed GLOBAL problem
size (strong scaling on one host) and prints the per-step halo traffic the
XLA latency-hiding scheduler must cover (the reference's
pre/post communicator split is src/mod_rhs_btp.F90:38-46).

Run:  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
          python tools/overlap_probe.py [--nel 32] [--json out.json]

Caveat: CPU "devices" are host threads sharing one memory system, so the
ratio measures XLA's scheduling/collective overhead, not the links
between cards. A ratio near
(ideal) 1/8 of serial per-shard compute means the ~200 ppermute rounds per
baroclinic dt are being overlapped/batched acceptably; a ratio >> compute
share means the halo path serializes and the interior/boundary split of
SURVEY §7.1 must be revisited.
"""
import argparse
import json
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--nel", type=int, default=32)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--json", default=None)
    args = p.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from hnumo_tpu.config import Config
    from hnumo_tpu.model import Model
    from hnumo_tpu.parallel.sharding import make_mesh

    nel = args.nel
    scale = 25.0 / nel
    cfg = Config(nelx=nel, nely=nel, nopx=4, nopy=4,
                 xdims=(0.0, 2e6), ydims=(0.0, 2e6), nlayers=2,
                 dt=500.0 * scale, dt_btp=25.0 * scale, time_final=1e9,
                 test_case="double_gyre", f0=9.3e-5, beta=2e-11,
                 botfr=1, cd_mlswe=1e-7, method_visc=2, visc_mlswe=100.0,
                 dtype="float32")

    def bench(mesh):
        m = Model(cfg, mesh=mesh)
        s = m.step(m.state0)
        s = m.step(s)
        jax.block_until_ready(s)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            s = m.step(s)
        jax.block_until_ready(s)
        assert bool(s.ok)
        return (time.perf_counter() - t0) / args.steps

    t1 = bench(None)
    ndev = len(jax.devices())
    mesh = make_mesh(jax.devices())
    tN = bench(mesh)
    py, px = mesh.shape["y"], mesh.shape["x"]

    # halo accounting per baroclinic dt (f32): each extract_faces issues 4
    # ppermutes (2 dirs x 2 neighbors) of one edge slab (ngl x local edge x
    # ngl values). Barotropic stage: 4 qb fields + 4 graduv fields = 8
    # extract_faces; 2 solves x n_btp x kstages stages; baroclinic side adds
    # ~3L-field rounds a handful of times per dt.
    ngl = cfg.nopx + 1
    n_btp = int(round(cfg.dt / cfg.dt_btp))
    stages = 2 * n_btp * 5
    slab_x = ngl * (nel // py) * ngl * 4   # bytes, x-direction edge slab
    exchanges_per_stage = 8 * 4
    halo_bytes_dt = stages * exchanges_per_stage * slab_x
    eff = t1 / (tN * ndev)

    out = {
        "grid": f"{nel}x{nel}", "devices": ndev, "mesh": f"{py}x{px}",
        "t_serial_ms": round(t1 * 1e3, 2), "t_sharded_ms": round(tN * 1e3, 2),
        "speedup": round(t1 / tN, 3), "scaling_efficiency": round(eff, 3),
        "btp_stages_per_dt": stages,
        "halo_bytes_per_dt": halo_bytes_dt,
        "note": "fake CPU mesh: measures XLA collective scheduling overhead,"
                " not the links between cards",
    }
    print(json.dumps(out, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
