"""Model facade: config -> geometry -> precomputed tables -> jitted step.

Replaces the reference driver wiring (src/amain.F90:12-190): grid init,
field init, and the time loop. The whole baroclinic step (predictor +
corrector + 2 barotropic sub-cycles) is one jitted pure function
`state -> state` with donated state buffers.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .config import Config
from .core.faces import BCs
from .core.init import build_precomputed
from .core.stepper import ti_rk_bcl
from .core.types import State
from .mesh.grid import build_geometry
from .ops.dg import device_geom


class Model:
    def __init__(self, cfg: Config, mesh=None):
        """`mesh`: optional jax.sharding.Mesh with axes ('y', 'x') — the
        element grid is block-decomposed over it (domain decomposition;
        replaces the reference's p4est partition + MPI halos, SURVEY §2.9).
        """
        self.cfg = cfg
        dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32
        # f64 validation runs need global x64. f32 runs do not enable it:
        # the δ-formulation's static reference vectors are assembled in f64
        # with host NumPy (core/init.py), so an f32 run never needs 64-bit
        # device types.
        if dtype == jnp.float64 and not jax.config.jax_enable_x64:
            jax.config.update("jax_enable_x64", True)
        # A GPU may run f32 dots in TF32 (about three decimal digits), which
        # is fatal for the pressure fields (pb ~ 4e5 Pa with ~1e2 signals;
        # docs/float32.md). The DG operators are tiny matrices; bandwidth,
        # not tensor-core throughput, bounds them, so full-f32 products cost
        # little.
        if jax.config.jax_default_matmul_precision is None:
            jax.config.update("jax_default_matmul_precision", "highest")
        self.dtype = dtype

        nop = cfg.nopx
        if cfg.nopy != cfg.nopx:
            raise NotImplementedError("anisotropic polynomial order not supported yet")
        zbot_ext = None
        if cfg.lread_external_grid:
            # external gmsh mesh path (reference read_gmsh + read_bathy,
            # src/read_gmsh.F90); BC codes come from the mesh's $BC section
            from .mesh.gmsh import geometry_from_msh

            self.geom, zbot_ext = geometry_from_msh(
                cfg.mesh_file, nop, exact_integration=cfg.dg_integ_exact,
                bathy_path=(cfg.bathymetry_file
                            if cfg.lread_external_bathy else None),
                use_bathy=cfg.lread_external_bathy)
            bc = self.geom.bc
            if zbot_ext is not None and cfg.bathymetry_shift:
                zbot_ext = zbot_ext + cfg.bathymetry_shift
            if (self.geom.nelx, self.geom.nely) != (cfg.nelx, cfg.nely):
                object.__setattr__(cfg, "nelx", self.geom.nelx)
                object.__setattr__(cfg, "nely", self.geom.nely)
        else:
            bc = (cfg.x_boundary[0], cfg.x_boundary[1],
                  cfg.y_boundary[0], cfg.y_boundary[1])
            self.geom = build_geometry(cfg.nelx, cfg.nely, nop, cfg.xdims,
                                       cfg.ydims, bc=bc,
                                       exact_integration=cfg.dg_integ_exact)
        self.g = device_geom(self.geom, dtype)
        self.bc = BCs(*bc)
        self.P, _state0, self.static, self.init_fields = build_precomputed(
            cfg, self.geom, dtype, zbot_ext=zbot_ext)
        # keep the initial state on host: step() donates its input buffer, so
        # state0 materializes a FRESH device state on every access
        import numpy as _np
        self._state0_host = jax.tree.map(_np.asarray, _state0)
        self._shardings = None

        self.mesh = mesh
        if mesh is None:
            static, bcs = self.static, self.bc

            # P and g are jit ARGUMENTS, not closure captures: captured
            # device arrays are baked into the HLO as literal constants, so
            # the compile payload (and compile time) grows with the grid —
            # ~100 MB of geometry tables at 256x256. As parameters they stay
            # runtime inputs with O(1) program size.
            @functools.partial(jax.jit, donate_argnums=(0,))
            def _step_args(state: State, Pre, geo) -> State:
                return ti_rk_bcl(static, Pre, geo, bcs, state)

            self._step = lambda state: _step_args(state, self.P, self.g)
        else:
            from jax import shard_map

            from .parallel.sharding import (blockify_tables, state_shardings,
                                            state_spec, table_specs)

            py, px = mesh.shape["y"], mesh.shape["x"]
            if cfg.nely % py or cfg.nelx % px:
                raise ValueError(
                    f"element grid {cfg.nely}x{cfg.nelx} not divisible by "
                    f"mesh {dict(mesh.shape)}")
            self.g, self.P = blockify_tables(self.g, self.P, px, py)
            self._shardings = state_shardings(mesh)

            static = self.static
            if cfg.batched_faces == "auto":
                # under shard_map the launch-latency regime is set by the
                # PER-DEVICE block, not the global grid — re-resolve "auto"
                # on per-shard elements (init.py resolved it globally)
                import dataclasses as _dc
                per_shard = (cfg.nelx * cfg.nely) // (px * py)
                static = _dc.replace(
                    static, batched_faces_on=(per_shard <= 8192))
                self.static = static
            # always name both axes (size-1 ppermute is identity); values are
            # device-varying over every mesh axis regardless of its size
            bcs = self.bc._replace(ax="x", ay="y")
            from jax.sharding import NamedSharding, PartitionSpec

            sspec = state_spec()
            gspec = table_specs(self.g, cfg.nely, cfg.nelx, px, py)
            pspec = table_specs(self.P, cfg.nely, cfg.nelx, px, py)
            is_spec = lambda x: isinstance(x, PartitionSpec)
            self.g = jax.device_put(self.g, jax.tree.map(
                lambda s: NamedSharding(mesh, s), gspec, is_leaf=is_spec))
            self.P = jax.device_put(self.P, jax.tree.map(
                lambda s: NamedSharding(mesh, s), pspec, is_leaf=is_spec))

            # check_vma stays ON for the compiled kernel — its outputs
            # declare their varying axes (ops.pallas_btp.sds). Interpret-mode
            # Pallas (CPU tests) mixes varying operands with replicated loop
            # indices inside the interpreter and fails the vma check, so the
            # check is off for that mode only.
            check_vma = not (static.use_pallas and static.pallas_interpret)
            step_local = shard_map(
                lambda state, Pre, geo: ti_rk_bcl(static, Pre, geo, bcs, state),
                mesh=mesh, in_specs=(sspec, pspec, gspec), out_specs=sspec,
                check_vma=check_vma)

            P_tables, g_tables = self.P, self.g

            @functools.partial(jax.jit, donate_argnums=(0,))
            def _step(state: State) -> State:
                return step_local(state, P_tables, g_tables)

            self._step = _step

    @property
    def state0(self) -> State:
        import jax.numpy as jnp

        s = State(*[jnp.asarray(a) for a in self._state0_host])
        if self._shardings is not None:
            s = jax.device_put(s, self._shardings)
        return s

    def step(self, state: State) -> State:
        s = self._step(state)
        if self.cfg.debug_checks:
            # debug mode (SURVEY §5): per-step finite-value sanitizer, the
            # runtime analog of the reference's debug builds. Costs a
            # host sync per step — off in production.
            import numpy as _np
            for name in ("qb_df", "q_df", "qprime_df"):
                a = _np.asarray(getattr(s, name))
                if not _np.all(_np.isfinite(a)):
                    bad = int((~_np.isfinite(a)).sum())
                    raise FloatingPointError(
                        f"debug_checks: {bad} non-finite values in {name} "
                        f"at t={float(s.t)}")
        return s

    def run(self, state: State, nsteps: int, check_ok: bool = True) -> State:
        for _ in range(nsteps):
            state = self.step(state)
            if check_ok and not bool(state.ok):
                raise RuntimeError(
                    "Negative mass in thickness at some points "
                    f"(t={float(state.t)}) — aborting, as the reference does "
                    "(src/mod_splitting.F90:74-77)")
        return state

    @property
    def nsteps_total(self) -> int:
        import math
        return int(round((self.cfg.t_final - self.cfg.t_initial) / self.cfg.dt))


def model_from_namelist(path, **overrides) -> Model:
    from .config import config_from_namelist
    return Model(config_from_namelist(path, **overrides))
