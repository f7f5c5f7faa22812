"""Gather-based flat face machinery on a genuinely unstructured mesh.

Phase 1 of docs/unstructured.md: the mesh
class the structured loader rejects — an interior extraordinary vertex —
must build, and the flat gather/scatter face ops must satisfy the exact
DG identities the structured path satisfies by construction."""
import numpy as np
import pytest

from hnumo_tpu.basis.lgl import lgl_points_weights
from hnumo_tpu.mesh.flatfaces import (FlatFaces, bilinear_coords,
                                      build_flat_faces, extract_traces,
                                      face_geometry, pinwheel_mesh,
                                      scatter_faces)

NGL = 5


def _dpsi(xgl):
    """Barycentric 1D differentiation matrix: D[i, j] = psi_j'(x_i), so
    (D @ u)[i] = du/ds at node i — the (m, n) layout face_geometry's
    einsum contracts ("fnc,mn->fmc": row m = evaluation node)."""
    x = np.asarray(xgl)
    n = len(x)
    w = np.ones(n)
    for j in range(n):
        for k in range(n):
            if k != j:
                w[j] /= (x[j] - x[k])
    D = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if i != j:
                D[i, j] = (w[j] / w[i]) / (x[i] - x[j])
        D[i, i] = -np.sum(D[i, [j for j in range(n) if j != i]])
    return D


def _setup():
    verts, quads = pinwheel_mesh()
    ff = build_flat_faces(quads, NGL)
    xgl, wgl = lgl_points_weights(NGL)
    coords = bilinear_coords(verts, quads, xgl)
    return verts, quads, ff, np.asarray(xgl), np.asarray(wgl), coords


def test_structured_loader_rejects_extraordinary_vertex():
    """The pinwheel is outside the structured class by construction."""
    from hnumo_tpu.mesh.gmsh import infer_structured_layout

    verts, quads = pinwheel_mesh()
    with pytest.raises(ValueError):
        infer_structured_layout(quads, native=False)


def test_face_counts_and_conformity():
    verts, quads, ff, xgl, wgl, coords = _setup()
    assert ff.n_interior == 3           # the 3 spokes at the center vertex
    assert ff.idx_L.shape == (9, NGL)   # + 6 boundary faces
    assert ff.is_boundary.sum() == 6


def test_traces_agree_on_interior_faces():
    """Nodal coordinates are continuous across faces: the L and R traces
    of the coordinate field must agree POINTWISE on interior faces —
    this pins both the index maps and the orientation folding."""
    verts, quads, ff, xgl, wgl, coords = _setup()
    import jax.numpy as jnp

    for c in range(2):
        u = jnp.asarray(coords[..., c])
        uL, uR = extract_traces(u, ff)
        err = np.abs(np.asarray(uL - uR))[:ff.n_interior]
        assert err.max() < 1e-14, f"coordinate {c} trace mismatch"


def test_scatter_is_adjoint_of_extract():
    """<extract(u), S> over faces == <u, scatter(S)> over elements — the
    discrete identity that makes the weak-form face integral conservative
    regardless of topology."""
    verts, quads, ff, xgl, wgl, coords = _setup()
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    E = quads.shape[0]
    u = jnp.asarray(rng.normal(size=(E, NGL, NGL)))
    SL = jnp.asarray(rng.normal(size=ff.idx_L.shape))
    SR = jnp.asarray(rng.normal(size=ff.idx_L.shape))
    uL, uR = extract_traces(u, ff)
    lhs = float((uL * SL).sum() + (uR * SR).sum())
    rhs = float((u * scatter_faces(jnp.zeros_like(u), SL, SR, ff)).sum())
    assert abs(lhs - rhs) < 1e-10 * max(1.0, abs(lhs))


def test_face_geometry_normals():
    """Outward-from-L unit normals + surface jacobians: (a) unit length;
    (b) the divergence theorem holds discretely — for F = (x, y),
    div F = 2, so sum over each element's faces of w*jac*(n . F) equals
    2*area. The pinwheel quads are straight-sided, so LGL quadrature is
    exact and areas are the polygon areas."""
    verts, quads, ff, xgl, wgl, coords = _setup()
    dpsi = _dpsi(xgl)
    nx, ny, jac = face_geometry(coords, ff, wgl, dpsi)
    assert np.allclose(nx * nx + ny * ny, 1.0, atol=1e-12)

    xy = coords.reshape(-1, 2)
    fx = xy[ff.idx_L][..., 0]
    fy = xy[ff.idx_L][..., 1]
    flux = jac * (nx * fx + ny * fy)       # (F, ngl) of w*jac*(n.F)
    per_elem = np.zeros(quads.shape[0])
    for f in range(ff.idx_L.shape[0]):
        per_elem[ff.elem_L[f]] += flux[f].sum()
        if not ff.is_boundary[f]:
            # R element sees the opposite outward normal
            per_elem[ff.elem_R[f]] -= flux[f].sum()
    areas = np.array([_poly_area(verts[quads[e]]) for e in
                      range(quads.shape[0])])
    assert np.allclose(per_elem, 2.0 * areas, rtol=1e-12)


def _poly_area(pts):
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
