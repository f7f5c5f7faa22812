"""Core DG tensor-product operators (jitted compute path).

Array-native replacement of the reference's per-quad-point gather/scatter
tables (src/Tensor_product.F90:1-128) and MXM kernels (src/mxm.F90): every
operation is a pair of small dense matmuls batched over all elements (and
layers/variables), with the element batch in the leading dimensions.

Field layouts (see hnumo_tpu.mesh.grid):
  nodal (..., nely, nelx, ngl_j, ngl_i), quad (..., nely, nelx, nq_j, nq_i).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class DeviceGeom(NamedTuple):
    """Geometry tables as device arrays (a pytree; close over it in jit)."""

    psiq: jnp.ndarray      # (ngl, nq)
    dpsiq: jnp.ndarray     # (ngl, nq)
    dpsi: jnp.ndarray      # (ngl, ngl)
    ksiq_x: jnp.ndarray    # (nely, nelx, nq, nq)
    ksiq_y: jnp.ndarray
    etaq_x: jnp.ndarray
    etaq_y: jnp.ndarray
    wjac: jnp.ndarray
    ksi_x: jnp.ndarray     # (nely, nelx, ngl, ngl)
    ksi_y: jnp.ndarray
    eta_x: jnp.ndarray
    eta_y: jnp.ndarray
    wjac_df: jnp.ndarray
    massinv: jnp.ndarray
    jac_facex: jnp.ndarray   # (nely, nelx+1, nq)
    nx_x: jnp.ndarray
    ny_x: jnp.ndarray
    jac_facey: jnp.ndarray   # (nely+1, nelx, nq)
    nx_y: jnp.ndarray
    ny_y: jnp.ndarray
    jac_facex_df: jnp.ndarray
    jac_facey_df: jnp.ndarray
    nx_x_df: jnp.ndarray
    ny_x_df: jnp.ndarray
    nx_y_df: jnp.ndarray
    ny_y_df: jnp.ndarray


def device_geom(geom, dtype) -> DeviceGeom:
    """Cast host Geometry tables to device arrays of the compute dtype."""
    vals = {}
    for name in DeviceGeom._fields:
        vals[name] = jnp.asarray(np.asarray(getattr(geom, name)), dtype=dtype)
    return DeviceGeom(**vals)


# ---------------------------------------------------------------------------
# volume operators
# ---------------------------------------------------------------------------

def interp_n2q(g: DeviceGeom, u):
    """Interpolate nodal field to over-integration quad points.

    (..., ngl, ngl) -> (..., nq, nq). Reference: psih gather,
    src/Tensor_product.F90:71 applied in every volume kernel.
    """
    return jnp.einsum("...ji,jJ,iI->...JI", u, g.psiq, g.psiq)


def grad_n2q(g: DeviceGeom, u):
    """Physical-space gradient of a nodal field, evaluated at quad points.

    Returns (du/dx, du/dy), each (..., nq, nq).
    Reference: dpsidx/dpsidy tables, src/Tensor_product.F90:74-81.
    """
    d_ksi = jnp.einsum("...ji,jJ,iI->...JI", u, g.psiq, g.dpsiq)
    d_eta = jnp.einsum("...ji,jJ,iI->...JI", u, g.dpsiq, g.psiq)
    ux = d_ksi * g.ksiq_x + d_eta * g.etaq_x
    uy = d_ksi * g.ksiq_y + d_eta * g.etaq_y
    return ux, uy


def grad_nodal(g: DeviceGeom, u):
    """Gradient of a nodal field at the nodal points themselves.

    Reference: compute_gradient_uv / dpsidx_df tables
    (src/mod_barotropic_terms.F90:411-443, src/Tensor_product.F90:89-124).
    """
    d_ksi = jnp.einsum("...ji,iI->...jI", u, g.dpsi)
    d_eta = jnp.einsum("...ji,jJ->...Ji", u, g.dpsi)
    ux = d_ksi * g.ksi_x + d_eta * g.eta_x
    uy = d_ksi * g.ksi_y + d_eta * g.eta_y
    return ux, uy


def scatter_volume(g: DeviceGeom, Fx=None, Fy=None, Fs=None):
    """Weak-form volume integral: rhs_I = sum_q w_q (dpsi_I/dx Fx + dpsi_I/dy Fy + psi_I Fs).

    Any of Fx/Fy/Fs (quad fields) may be None. Returns a nodal field WITHOUT
    the inverse mass applied (matches reference volume kernels, e.g.
    src/mod_rhs_btp.F90:194-206).
    """
    out = None
    if Fx is not None or Fy is not None:
        zero = 0.0
        fx = Fx if Fx is not None else zero
        fy = Fy if Fy is not None else zero
        a_ksi = g.wjac * (fx * g.ksiq_x + fy * g.ksiq_y)
        a_eta = g.wjac * (fx * g.etaq_x + fy * g.etaq_y)
        out = jnp.einsum("...JI,jJ,iI->...ji", a_ksi, g.psiq, g.dpsiq)
        out = out + jnp.einsum("...JI,jJ,iI->...ji", a_eta, g.dpsiq, g.psiq)
    if Fs is not None:
        s = jnp.einsum("...JI,jJ,iI->...ji", g.wjac * Fs, g.psiq, g.psiq)
        out = s if out is None else out + s
    return out


def scatter_volume_nodal(g: DeviceGeom, Fx, Fy):
    """Weak-form volume integral evaluated with the NODAL quadrature.

    rhs_I = sum_n w_n (dpsi_I/dx(x_n) Fx_n + dpsi_I/dy(x_n) Fy_n), used by the
    nodal-family LDG viscosity (reference btp_compute_laplacian,
    src/mod_laplacian_quad.F90:357-425, which integrates with wjac_df and the
    dpsidx_df tables).
    """
    a_ksi = g.wjac_df * (Fx * g.ksi_x + Fy * g.ksi_y)
    a_eta = g.wjac_df * (Fx * g.eta_x + Fy * g.eta_y)
    out = jnp.einsum("...jI,iI->...ji", a_ksi, g.dpsi)
    out = out + jnp.einsum("...Ji,jJ->...ji", a_eta, g.dpsi)
    return out


def project_q2n(g: DeviceGeom, f):
    """L2-project a quad field back to nodal dofs (with inverse lumped mass).

    Reference: interpolate_layer_from_quad_to_node_1d
    (src/mod_Tensorproduct.F90:166-215).
    """
    return g.massinv * jnp.einsum("...JI,jJ,iI->...ji", g.wjac * f, g.psiq, g.psiq)
