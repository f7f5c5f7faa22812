"""Domain decomposition over a device mesh via shard_map.

Replacement of the reference's p4est partition + MPI halo
exchange (src/p4est.c:1030-1187, src/send_receive_bound.F90,
src/create_rhs_communicator.F90). The element grid (nely, nelx) is block-
decomposed over a 2D `jax.sharding.Mesh` with axes ('y', 'x') and the whole
baroclinic step runs inside `shard_map`: each shard owns a (ly, lx) element
block; face-trace extraction fetches one neighbor element-edge slab per
direction with `lax.ppermute` (see hnumo_tpu.core.faces), exactly the thin
face halos of the reference, and XLA's latency-hiding scheduler overlaps
them with the volume einsums (the reference's hand-rolled pre/post
communicator split, src/mod_rhs_btp.F90:38-46).

Face-geometry tables are stored in a BLOCKED-OVERLAPPING layout when
sharded: the global (ney, nex+1, n) x-face table becomes
(ney, px*(lx+1), n) where block b holds faces [b*lx, b*lx+lx] — shard-
boundary faces are duplicated on both owners (each side computes the shared
face flux redundantly from identical exchanged traces; no extra comm).
With a 1x1 mesh the blocked layout degenerates to the serial one.

The vertical `nlayers` and variable axes are never sharded (batch dims, as
in the reference where every rank holds all layers; SURVEY §2.9).
"""
from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def to_host(x) -> np.ndarray:
    """Gather a (possibly multi-host-sharded) array to host NumPy.

    Replacement of the reference's mpi_gatherv I/O gather
    (src/gather_data.F90:1-66): single-process (even multi-device) arrays
    are fully addressable and np.asarray suffices; across processes the
    global array is assembled with multihost_utils.process_allgather
    (tiled=True keeps the global layout, matching the reference's DG
    concatenation order)."""
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def make_mesh(devices=None, shape: tuple[int, int] | None = None) -> Mesh:
    """Build a 2D ('y', 'x') device mesh for element-grid decomposition.

    With no arguments, uses all visible devices in an as-square-as-possible
    layout. Devices fill the mesh in the order given, row-major: the cards
    of one host are joined all to all, so the layout follows the element
    decomposition alone.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        py = int(math.sqrt(n))
        while n % py:
            py -= 1
        shape = (py, n // py)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    return Mesh(np.asarray(devices).reshape(shape), axis_names=("y", "x"))


def state_spec():
    """PartitionSpecs for the State pytree.

    Layouts (core.types.State): qb_df (4, ney, nex, ngl, ngl);
    q_df / qprime_df (3, nlayers, ney, nex, ngl, ngl); t, ok scalars.
    """
    from ..core.types import State

    return State(
        qb_df=P(None, "y", "x", None, None),
        q_df=P(None, None, "y", "x", None, None),
        qprime_df=P(None, None, "y", "x", None, None),
        t=P(),
        ok=P(),
    )


def state_shardings(mesh: Mesh):
    return jax.tree.map(
        lambda s: NamedSharding(mesh, s),
        state_spec(),
        is_leaf=lambda x: isinstance(x, P),
    )


# ---------------------------------------------------------------------------
# blocked-overlapping face-table layout
# ---------------------------------------------------------------------------

def _blockify(a: np.ndarray, nblocks: int, axis: int) -> np.ndarray:
    """(..., n*lx+1, ...) -> (..., nblocks*(lx+1), ...): block b holds entries
    [b*lx, b*lx+lx] (shared entries duplicated)."""
    if nblocks == 1:
        return a
    nfaces = a.shape[axis]
    lx = (nfaces - 1) // nblocks
    assert lx * nblocks + 1 == nfaces, (nfaces, nblocks)
    idx = [slice(None)] * a.ndim
    blocks = []
    for b in range(nblocks):
        idx[axis] = slice(b * lx, b * lx + lx + 1)
        blocks.append(a[tuple(idx)])
    return np.concatenate(blocks, axis=axis)


# DeviceGeom fields that are x-face / y-face tables (see ops.dg.DeviceGeom)
_GEOM_XFACE = ("jac_facex", "nx_x", "ny_x", "jac_facex_df", "nx_x_df", "ny_x_df")
_GEOM_YFACE = ("jac_facey", "nx_y", "ny_y", "jac_facey_df", "nx_y_df", "ny_y_df")


def blockify_tables(g, Pre, px: int, py: int):
    """Rewrite DeviceGeom `g` and Precomputed `Pre` face tables into the
    blocked-overlapping layout for a (py, px) mesh. Element tables unchanged.
    Returns (g, Pre) with jnp arrays preserved as-is dtype-wise."""
    import jax.numpy as jnp

    def bx(a):  # x-face table: face axis is -2 ((..., ney, nex+1, n))
        return jnp.asarray(_blockify(np.asarray(a), px, a.ndim - 2))

    def by(a):  # y-face table: face axis is -3 ((..., ney+1, nex, n))
        return jnp.asarray(_blockify(np.asarray(a), py, a.ndim - 3))

    g = g._replace(**{f: bx(getattr(g, f)) for f in _GEOM_XFACE},
                   **{f: by(getattr(g, f)) for f in _GEOM_YFACE})
    fx = type(Pre.faces.x)(*[bx(a) for a in Pre.faces.x])
    fy = type(Pre.faces.y)(*[by(a) for a in Pre.faces.y])
    Pre = Pre._replace(faces=type(Pre.faces)(fx, fy))
    return g, Pre


def table_specs(pytree, ney: int, nex: int, px: int, py: int):
    """PartitionSpec pytree for static tables: element tables shard their
    (ney, nex) axis pair over ('y','x'); blocked face tables shard their
    (ney, px*(lx+1)) / (py*(ly+1), nex) axes; everything else replicated."""
    bx = px * (nex // px + 1)
    byy = py * (ney // py + 1)
    pairs = {(ney, nex), (ney, bx), (byy, nex)}

    def spec(a):
        if not hasattr(a, "shape") or a.ndim < 2:
            return P()
        shp = a.shape
        for i in range(a.ndim - 1):
            if (shp[i], shp[i + 1]) in pairs:
                s = [None] * a.ndim
                s[i], s[i + 1] = "y", "x"
                return P(*s)
        return P()

    return jax.tree.map(spec, pytree)


def table_shardings(pytree, mesh: Mesh, ney: int, nex: int):
    px, py = mesh.shape["x"], mesh.shape["y"]
    specs = table_specs(pytree, ney, nex, px, py)
    return jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                        pytree, specs)
