"""Becker 2009 corotated SPH elasticity.

Port of ``salva_tpu.solver.elasticity``
(``src/solver/elasticity/becker2009_elasticity.rs``): the rest state
(rest positions, rest contact table from the gather neighbour search,
rest volumes) is captured when the world is prepared; each solve
extracts per-particle rotations by batched polar decomposition, forms
corotated (linear or Green) strain -> stress in the symmetric
``SpatialVector`` layout, and accumulates the symmetrized pair forces
over the *rest* contact table.

Rotation extraction: the reference warm-starts nalgebra's iterative
``Rotation::from_matrix_eps`` (`:115-137`); both packages use a batched
SVD polar decomposition with a reflection fix and an identity fallback
for degenerate APQ matrices. ``torch.linalg.svd`` picks other singular
vector signs than JAX's, but the rotation ``U diag(1, .., det(U V^T))
V^T`` of an invertible matrix does not depend on that choice.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .common import StepContext


@dataclasses.dataclass
class ElasticityState:
    """Persistent rest-state data over the merged particle array.

    ``rest_j / rest_valid / rest_w / rest_grad``: the rest-configuration
    contact table (``compute_self_contacts`` + kernel fill,
    `becker2009_elasticity.rs:95-106`); rows of particles without
    elasticity are empty."""

    positions0: torch.Tensor  # [N, dim]
    volumes0: torch.Tensor  # [N]
    rest_j: torch.Tensor  # [N, Ke] int64
    rest_valid: torch.Tensor  # [N, Ke] bool
    rest_w: torch.Tensor  # [N, Ke]
    rest_grad: torch.Tensor  # [N, Ke, dim]

    @property
    def rest_mask(self):
        return self.rest_valid.to(self.rest_w.dtype)


def build_elasticity_state(fluids, rest_contacts,
                           active_mask) -> ElasticityState:
    """Capture the rest state (`becker2009_elasticity.rs:84-113`).

    ``rest_contacts``: a ``Contacts`` table evaluated on the rest
    positions, restricted to same-fluid pairs of elasticity-carrying
    fluids. Rest volumes replicate the reference's accumulation, which
    visits every unordered pair twice: ``V0_i = m_i / (2 sum_j m_j
    W0_ij)``."""
    m_j = fluids.masses[rest_contacts.j]
    denom = 2.0 * torch.sum(m_j * rest_contacts.w, dim=1)
    safe = torch.where(denom > 0.0, denom, 1.0)
    volumes0 = torch.where(active_mask & (denom > 0.0),
                           fluids.masses / safe, 0.0)
    return ElasticityState(
        positions0=fluids.positions,
        volumes0=volumes0,
        rest_j=rest_contacts.j,
        rest_valid=rest_contacts.valid,
        rest_w=rest_contacts.w,
        rest_grad=rest_contacts.grad,
    )


def _polar_rotation(a, dim: int):
    """Batched rotation factor of [N, dim, dim] matrices via SVD:
    R = U diag(1, .., det(U V^T)) V^T; identity for near-zero
    matrices."""
    ok = (torch.sum(a * a, dim=(-2, -1)) > 1e-12)[:, None, None]
    eye = torch.eye(dim, dtype=a.dtype, device=a.device)[None]
    u, _, vt = torch.linalg.svd(torch.where(ok, a, eye), full_matrices=False)
    fix = torch.ones(a.shape[0], dim, dtype=a.dtype, device=a.device)
    fix[:, -1] = torch.linalg.det(u @ vt)
    r = torch.einsum("nij,nj,njk->nik", u, fix, vt)
    return torch.where(ok, r, eye)


def _sym_mat_mul_vec(s, v, dim: int):
    """SpatialVector (symmetric matrix) times vector
    (`becker2009_elasticity.rs:27-38`). 2D layout [xx, yy, xy]; 3D
    [xx, yy, zz, xy, xz, yz]."""
    if dim == 2:
        return torch.stack([
            s[..., 0] * v[..., 0] + s[..., 2] * v[..., 1],
            s[..., 2] * v[..., 0] + s[..., 1] * v[..., 1],
        ], dim=-1)
    return torch.stack([
        s[..., 0] * v[..., 0] + s[..., 3] * v[..., 1] + s[..., 4] * v[..., 2],
        s[..., 3] * v[..., 0] + s[..., 1] * v[..., 1] + s[..., 5] * v[..., 2],
        s[..., 4] * v[..., 0] + s[..., 5] * v[..., 1] + s[..., 2] * v[..., 2],
    ], dim=-1)


def elasticity_coefficients(young_modulus: float, poisson_ratio: float):
    """(d0, d1, d2) Lamé-like coefficients
    (`becker2009_elasticity.rs:15-25`)."""
    e, nu = young_modulus, poisson_ratio
    d0 = (e * (1.0 - nu)) / ((1.0 + nu) * (1.0 - 2.0 * nu))
    d1 = (e * nu) / ((1.0 + nu) * (1.0 - 2.0 * nu))
    d2 = (e * (1.0 - 2.0 * nu)) / (2.0 * (1.0 + nu) * (1.0 - 2.0 * nu))
    return d0, d1, d2


# The reference's shear-strain factor: nominally 0.5 but literally 0.564 in
# `compute_stresses` (`becker2009_elasticity.rs:142`). Kept for parity.
_SHEAR_HALF = 0.564


@dataclasses.dataclass(frozen=True)
class Becker2009ElasticityForce:
    """Corotated linear-FEM-style SPH elasticity.

    ``d0 / d1 / d2``: per-fluid coefficient tuples from
    :func:`elasticity_coefficients`; ``nonlinear``: per-fluid 0/1 flags
    for Green strain; ``active``: per-fluid 0/1 participation flags."""

    d0: Tuple[float, ...]
    d1: Tuple[float, ...]
    d2: Tuple[float, ...]
    nonlinear: Tuple[int, ...]
    active: Tuple[int, ...]
    kind: str = dataclasses.field(default="becker2009_elasticity",
                                  init=False)

    def apply(self, ctx: StepContext, es: ElasticityState):
        accel = self.apply_particles(ctx.fluids, es, ctx.dim)
        return accel, torch.zeros_like(ctx.boundaries.forces)

    def apply_particles(self, fl, es: ElasticityState, dim: int):
        """Particle-layout core: accel [N, dim] from positions and the
        rest contact table only (no spatial search), so the dense
        substep runs it too and bins the result into its grid
        (`becker2009_elasticity.rs:268-334`)."""
        pos = fl.positions
        j = es.rest_j
        mask = es.rest_mask
        fid = fl.fluid_id.long()

        def per_fluid(values):
            return torch.tensor(values, dtype=torch.float32,
                                device=pos.device)[fid]

        active_i = per_fluid(self.active)
        d0_i = per_fluid(self.d0)
        d1_i = per_fluid(self.d1)
        d2_i = per_fluid(self.d2)
        nonlin = per_fluid(self.nonlinear) > 0

        p_ji = pos[j] - pos[:, None, :]  # [N, Ke, dim]
        p0_ji = es.positions0[j] - es.positions0[:, None, :]

        # Rotations from the APQ shape-matching matrix (`:115-137`).
        coeff = es.rest_w * fl.masses[j] * mask
        a_pq = torch.einsum("nk,nkd,nke->nde", coeff, p_ji, p0_ji)
        rot = _polar_rotation(a_pq, dim)  # [N, dim, dim]

        # Deformation gradient transpose (`:139-195`):
        # u_ji = R_i^T p_ji - p0_ji; grad_tr = sum (grad0 V0_j) u_ji^T.
        u_ji = torch.einsum("ned,nke->nkd", rot, p_ji) - p0_ji
        gv = es.rest_grad * (es.volumes0[j] * mask)[..., None]
        grad_tr = torch.einsum("nkd,nke->nde", gv, u_ji)  # [N, dim, dim]

        # Strain -> stress in SpatialVector layout (`:196-262`).
        eye = torch.eye(dim, dtype=pos.dtype, device=pos.device)
        jmat = grad_tr + eye[None]
        jjt = torch.einsum("nde,nfe->ndf", jmat, jmat)

        def top_left(v_diag):
            # C_top_left @ diag strain with C = [[d0, d1, ...], ...].
            s = torch.sum(v_diag, dim=-1, keepdim=True)
            return v_diag * (d0_i - d1_i)[:, None] + s * d1_i[:, None]

        diag_idx = list(range(dim))
        lin_diag = grad_tr[:, diag_idx, diag_idx]
        nl_diag = (jjt[:, diag_idx, diag_idx] - 1.0) * _SHEAR_HALF
        if dim == 2:
            lin_shear = ((grad_tr[:, 1, 0] + grad_tr[:, 0, 1])
                         * _SHEAR_HALF * d2_i)[:, None]
            nl_shear = (jjt[:, 1, 0] * _SHEAR_HALF * d2_i)[:, None]
        else:
            lin_shear = torch.stack([
                grad_tr[:, 1, 0] + grad_tr[:, 0, 1],
                grad_tr[:, 2, 0] + grad_tr[:, 0, 2],
                grad_tr[:, 1, 2] + grad_tr[:, 2, 1],
            ], dim=-1) * (_SHEAR_HALF * d2_i[:, None])
            nl_shear = torch.stack(
                [jjt[:, 1, 0], jjt[:, 2, 0], jjt[:, 2, 1]], dim=-1
            ) * (_SHEAR_HALF * d2_i[:, None])
        stress = torch.cat([
            torch.where(nonlin[:, None], top_left(nl_diag),
                        top_left(lin_diag)),
            torch.where(nonlin[:, None], nl_shear, lin_shear),
        ], dim=-1)  # [N, 3] / [N, 6]

        # Pair forces over rest contacts (`:268-334`).
        v0_i = es.volumes0
        v0_j = v0_i[j]
        sigma_d_ij = _sym_mat_mul_vec(stress[:, None, :],
                                      es.rest_grad * v0_j[..., None], dim)
        extra_i = torch.einsum("nde,nke->nkd", grad_tr, sigma_d_ij)
        f_ji = torch.where(nonlin[:, None, None], sigma_d_ij + extra_i,
                           sigma_d_ij) * (-v0_i[:, None, None])

        sigma_d_ji = _sym_mat_mul_vec(stress[j],
                                      es.rest_grad * (-v0_i[:, None, None]),
                                      dim)
        extra_j = torch.einsum("nkde,nke->nkd", grad_tr[j], sigma_d_ji)
        f_ij = torch.where(nonlin[j][..., None], sigma_d_ji + extra_j,
                           sigma_d_ji) * (-v0_j[..., None])

        force = (torch.einsum("nkde,nke->nkd", rot[j], f_ij)
                 - torch.einsum("nde,nke->nkd", rot, f_ji)) * 0.5
        m_i = fl.volumes * fl.density0
        safe_m = torch.where(m_i > 0.0, m_i, 1.0)
        accel = torch.sum(force * mask[..., None], dim=1) / safe_m[:, None]
        return accel * active_i[:, None]
