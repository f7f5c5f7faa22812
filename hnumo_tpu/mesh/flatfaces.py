"""Gather-based flat face machinery for genuinely unstructured quad meshes.

Phase 1 of docs/unstructured.md: the building blocks that replace the
structured edge-slab face path when a mesh has extraordinary vertices
(valence != 4) and therefore no (ey, ex) logical layout.

Reference counterpart: the face builder of create_normals_quad
(src/create_normals_quad.F90:227 builds imapl_q/imapr_q per-face node
index maps) and the p4est external-connectivity door
(src/p4est.c:1030-1187). This design differs structurally: element
storage stays DENSE element-major (C, E, ngl, ngl) — DG shares no nodes
across elements, so volume kernels need no index tables — and only the
face pipeline uses precomputed flat int32 index maps:

    traces   uL = u.reshape(..., E*ngl*ngl)[..., idx_L]   # one XLA gather
    scatter  rhs = rhs.at[..., idx].add(S)                # one segment-sum

Orientation (the reference's per-face `orient` switch) is FOLDED INTO the
index order of idx_R at build time, so the runtime has no orientation
branches. Boundary faces carry R = L with a per-face mirror sign mask
(the reference's er<0 BC switch, src/mod_barotropic_terms.F90:79-92).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# local edge -> the (j, i) nodal indices along it, in counterclockwise
# element order: side 0 = south (j=0, i ascending), 1 = east (i=ngl-1,
# j ascending), 2 = north (j=ngl-1, i descending), 3 = west (i=0,
# j descending). Corner k..k+1 of the quad spans side k.
_SIDE_CORNERS = [(0, 1), (1, 2), (2, 3), (3, 0)]


def _side_nodes(side: int, ngl: int) -> np.ndarray:
    """Linear (j*ngl + i) node indices along a local side, CCW order."""
    r = np.arange(ngl)
    if side == 0:
        j, i = np.zeros(ngl, int), r
    elif side == 1:
        j, i = r, np.full(ngl, ngl - 1)
    elif side == 2:
        j, i = np.full(ngl, ngl - 1), r[::-1]
    else:
        j, i = r[::-1], np.zeros(ngl, int)
    return j * ngl + i


@dataclass
class FlatFaces:
    """Flat face index tables for an arbitrary conforming quad mesh.

    F faces total (interior first, then boundary). All arrays np.int32 /
    float64 host tables; callers jnp.asarray what they need.
    """

    idx_L: np.ndarray       # (F, ngl) linear indices into (E*ngl*ngl,)
    idx_R: np.ndarray       # (F, ngl); boundary faces repeat idx_L
    elem_L: np.ndarray      # (F,)
    elem_R: np.ndarray      # (F,) = elem_L on boundary faces
    side_L: np.ndarray      # (F,)
    is_boundary: np.ndarray  # (F,) bool
    n_interior: int


def build_flat_faces(quads: np.ndarray, ngl: int) -> FlatFaces:
    """Build flat face tables from (E, 4) CCW vertex-id connectivity.

    Accepts ANY conforming quad mesh — extraordinary vertices included —
    which is exactly the class the structured BFS loader (mesh/gmsh.py)
    rejects. T-junctions (an edge appearing with >2 elements or a vertex
    pair mismatch) raise. Matching edges get idx_R in the REVERSED node
    order of idx_L (two CCW elements traverse a shared edge oppositely),
    which is the only orientation a conforming quad mesh admits.
    """
    E = quads.shape[0]
    edge_owner: dict[tuple[int, int], tuple[int, int]] = {}
    rows_L, rows_R = [], []
    eL, eR, sL, bnd = [], [], [], []
    # interior faces
    boundary = []
    for e in range(E):
        for s in range(4):
            a, b = (int(quads[e, _SIDE_CORNERS[s][0]]),
                    int(quads[e, _SIDE_CORNERS[s][1]]))
            key = (min(a, b), max(a, b))
            if key in edge_owner:
                (e0, s0) = edge_owner.pop(key)
                a0 = int(quads[e0, _SIDE_CORNERS[s0][0]])
                if a0 == a:
                    raise ValueError(
                        f"edge {key}: same traversal direction in elements "
                        f"{e0} and {e} — mesh is not consistently oriented")
                rows_L.append(e0 * ngl * ngl + _side_nodes(s0, ngl))
                # R runs the same physical direction as L: reverse R's CCW
                rows_R.append(e * ngl * ngl + _side_nodes(s, ngl)[::-1])
                eL.append(e0)
                eR.append(e)
                sL.append(s0)
                bnd.append(False)
            else:
                edge_owner[key] = (e, s)
    # remaining edges are domain boundary
    for (key, (e, s)) in sorted(edge_owner.items(),
                                key=lambda kv: (kv[1][0], kv[1][1])):
        idx = e * ngl * ngl + _side_nodes(s, ngl)
        boundary.append((idx, e, s))
    n_int = len(rows_L)
    for idx, e, s in boundary:
        rows_L.append(idx)
        rows_R.append(idx)
        eL.append(e)
        eR.append(e)
        sL.append(s)
        bnd.append(True)
    return FlatFaces(
        idx_L=np.asarray(rows_L, np.int32),
        idx_R=np.asarray(rows_R, np.int32),
        elem_L=np.asarray(eL, np.int32), elem_R=np.asarray(eR, np.int32),
        side_L=np.asarray(sL, np.int32),
        is_boundary=np.asarray(bnd, bool), n_interior=n_int)


def extract_traces(u, ff: FlatFaces):
    """(..., E, ngl, ngl) -> (uL, uR), each (..., F, ngl): ONE gather per
    side, batched over leading channel/layer axes."""
    import jax.numpy as jnp

    flat = u.reshape(u.shape[:-3] + (-1,))
    return flat[..., ff.idx_L], flat[..., ff.idx_R]


def scatter_faces(rhs, S_L, S_R, ff: FlatFaces):
    """Accumulate per-face values into both owners' edge nodes.

    rhs: (..., E, ngl, ngl); S_L/S_R: (..., F, ngl) contributions for the
    L (respectively R) element of each face (sign conventions are the
    caller's, matching scatter_face_x/y). Boundary faces must carry their
    full contribution in S_L with S_R zeroed there (idx_R aliases idx_L).
    One segment-sum per side."""
    shp = rhs.shape
    flat = rhs.reshape(shp[:-3] + (-1,))
    flat = flat.at[..., ff.idx_L].add(S_L)
    flat = flat.at[..., ff.idx_R].add(S_R)
    return flat.reshape(shp)


def face_geometry(coords, ff: FlatFaces, wq, dpsi):
    """Per-face unit normals (outward from L), edge jacobian weights.

    coords: (E, ngl, ngl, 2) nodal coordinates (bilinear corner map or
    curvilinear); returns (nx, ny, jac) each (F, ngl) with jac = w * |dx/ds|
    along the face — the flat-table analog of the structured
    jac_facex/nx_x tables (mesh/grid.py), built with the same 1D LGL
    derivative matrix `dpsi` ((ngl, ngl), d psi_m / d xi at node n).
    """
    E, ngl = coords.shape[0], coords.shape[1]
    xy = coords.reshape(E * ngl * ngl, 2)
    fxy = xy[ff.idx_L]                      # (F, ngl, 2) along-face coords
    # d(x,y)/ds via the 1D derivative matrix in the face parameter
    dxy = np.einsum("fnc,mn->fmc", fxy, dpsi)
    tx, ty = dxy[..., 0], dxy[..., 1]
    jac_s = np.sqrt(tx * tx + ty * ty)
    # outward-from-L normal = tangent rotated -90deg for CCW traversal
    nx = ty / jac_s
    ny = -tx / jac_s
    return nx, ny, wq[None, :] * jac_s


def pinwheel_mesh():
    """The minimal genuinely unstructured conforming quad mesh: 3 quads
    fully surrounding an INTERIOR valence-3 (extraordinary) vertex — no
    (ey, ex) logical layout exists for it, so the structured BFS loader
    (mesh/gmsh.py) must reject it while this module accepts it.
    Returns (vertices (V, 2), quads (E, 4) CCW)."""
    import math

    ring = [(math.cos(math.radians(60 * k)), math.sin(math.radians(60 * k)))
            for k in range(6)]
    verts = np.array([[0.0, 0.0]] + ring)         # 0 = center, 1..6 = ring
    quads = np.array([
        [0, 1, 2, 3],     # center, 0deg, 60deg, 120deg   (CCW)
        [0, 3, 4, 5],     # center, 120deg, 180deg, 240deg
        [0, 5, 6, 1],     # center, 240deg, 300deg, 360deg
    ])
    return verts, quads


def bilinear_coords(verts, quads, xgl):
    """Nodal coordinates of each element via the bilinear corner map.

    xgl: (ngl,) LGL nodes on [-1, 1]. Returns (E, ngl, ngl, 2)."""
    ngl = len(xgl)
    s = (np.asarray(xgl) + 1.0) / 2.0
    a = s[None, :]                       # i (x-like)
    b = s[:, None]                       # j
    E = quads.shape[0]
    out = np.empty((E, ngl, ngl, 2))
    for e in range(E):
        v0, v1, v2, v3 = (verts[quads[e, k]] for k in range(4))
        for c in range(2):
            out[e, :, :, c] = ((1 - a) * (1 - b) * v0[c] + a * (1 - b) * v1[c]
                               + a * b * v2[c] + (1 - a) * b * v3[c])
    return out
