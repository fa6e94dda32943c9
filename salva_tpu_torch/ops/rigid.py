"""The rigid bodies' contact solve: sequential impulses over a contact
table.

``solve_contacts`` runs ``iterations`` passes over the first ``count``
rows of a compacted contact table (at most ``K``: body ``a``, body ``b``
or -1 for a fixed collider, point ``p``, normal ``n`` pointing out of the
other shape). Each contact applies the normal impulse that cancels the
normal relative velocity (restitution ``e``), its accumulated sum clamped
at 0, and then, while the accumulated normal impulse is positive, a
Coulomb friction impulse against the tangential relative velocity
clamped to ``friction`` times it; two-body contacts apply equal and
opposite impulses. Body poses and inverse masses are read; the linear and
angular velocities are returned updated.

It is the device coupling's ``_solve_velocities_dev``
(``salva_tpu/coupling/device_pipeline.py:347-416``): a ``lax.scan`` over
the contacts inside a scan over the iterations, with no Pallas kernel.
Each contact depends on the one before it, so it is a sequence of
``iterations * count`` small updates (at most 8 x 64): as eager PyTorch
ops that is ~10^4 launches a substep, host-bound. For CUDA tensors
``solve_contacts`` launches ``csrc/rigid_solve.cu``, one thread that runs
the whole sequence on the card and reads ``count`` from device memory (no
host sync); for CPU tensors it runs ``solve_contacts_plain``, the same
arithmetic as PyTorch ops. Every launch adds one to
``LAUNCHES["rigid_solve"]``.
"""

from __future__ import annotations

import torch

LAUNCHES = {"rigid_solve": 0}
MAX_CONTACTS = 256  # csrc/rigid_solve.cu kMaxContacts


def reset_launches():
    LAUNCHES["rigid_solve"] = 0


def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _dot(a, b):
    s = a[0] * b[0]
    for i in range(1, a.shape[0]):
        s = s + a[i] * b[i]
    return s


class _Bodies:
    """Per-body reads and impulse writes of one solve (plain version)."""

    def __init__(self, trans, rot, linvel, angvel, inv_mass, inv_inertia):
        self.dim = trans.shape[1]
        self.trans, self.rot = trans, rot
        self.lin, self.ang = linvel.clone(), angvel.clone()
        self.inv_mass, self.inv_inertia = inv_mass, inv_inertia

    def point_vel(self, body, p):
        r = p - self.trans[body]
        if self.dim == 2:
            return self.lin[body] + self.ang[body] * torch.stack([-r[1], r[0]])
        return self.lin[body] + _cross(self.ang[body], r)

    def _world_inv_inertia(self, body, tau):
        R = self.rot[body]
        return R @ (self.inv_inertia[body] * (R.T @ tau))

    def eff_mass(self, body, p, axis):
        r = p - self.trans[body]
        if self.dim == 2:
            rn = r[0] * axis[1] - r[1] * axis[0]
            return self.inv_mass[body] + rn * rn * self.inv_inertia[body, 0]
        iw = self._world_inv_inertia(body, _cross(r, axis))
        return self.inv_mass[body] + _dot(_cross(iw, r), axis)

    def apply(self, body, imp, p):
        self.lin[body] += imp * self.inv_mass[body]
        r = p - self.trans[body]
        if self.dim == 2:
            tau = r[0] * imp[1] - r[1] * imp[0]
            self.ang[body] += tau * self.inv_inertia[body, 0]
        else:
            self.ang[body] += self._world_inv_inertia(body, _cross(r, imp))


def solve_contacts_plain(trans, rot, linvel, angvel, inv_mass, inv_inertia,
                         a, b, p, n, count, restitution: float,
                         friction: float, iterations: int, tally=None):
    """The plain PyTorch version (the loop runs on the host, the
    arithmetic in float32 tensor ops on the inputs' device). Contacts at
    or past ``count`` change nothing, so the loop stops there.

    ``tally``, a dict, counts the impulses applied, keyed by
    ``("normal" | "friction", bodies)`` with ``bodies`` 1 for a contact
    against a fixed collider and 2 for one between two bodies: the work
    this data needs (a bound on the solve's time reads it)."""
    bodies = _Bodies(trans, rot, linvel, angvel, inv_mass, inv_inertia)
    num = int(count)
    a_l, b_l = a[:num].tolist(), b[:num].tolist()
    acc = [torch.zeros((), dtype=p.dtype, device=p.device)] * num
    for _ in range(iterations):
        for k in range(num):
            ka, kb, pk, nk = a_l[k], b_l[k], p[k], n[k]

            def rel_vel():
                v = bodies.point_vel(ka, pk)
                return v - bodies.point_vel(kb, pk) if kb >= 0 else v

            def pair_mass(axis):
                m = bodies.eff_mass(ka, pk, axis)
                return m + bodies.eff_mass(kb, pk, axis) if kb >= 0 else m

            def apply(imp):
                bodies.apply(ka, imp, pk)
                if kb >= 0:
                    bodies.apply(kb, -imp, pk)

            vn = _dot(rel_vel(), nk)
            kn = pair_mass(nk)
            if not bool(kn > 0.0):
                continue
            nb = 2 if kb >= 0 else 1
            if tally is not None:
                tally["normal", nb] = tally.get(("normal", nb), 0) + 1
            j = -(1.0 + restitution) * vn / kn
            new_acc = torch.clamp(acc[k] + j, min=0.0)
            dj = new_acc - acc[k]
            acc[k] = new_acc
            apply(dj * nk)
            if friction > 0.0:
                v = rel_vel()
                vt = v - _dot(v, nk) * nk
                vt_norm = torch.sqrt(_dot(vt, vt))
                if not (bool(acc[k] > 0.0) and bool(vt_norm > 1e-6)):
                    continue
                tdir = vt / vt_norm
                kt = pair_mass(tdir)
                if not bool(kt > 0.0):
                    continue
                lim = friction * acc[k]
                jt = torch.clamp(-vt_norm / kt, -lim, lim)
                apply(jt * tdir)
                if tally is not None:
                    tally["friction", nb] = tally.get(("friction", nb), 0) + 1
    return bodies.lin, bodies.ang


def _check(trans, rot, linvel, angvel, inv_mass, inv_inertia, a, b, p, n,
           count):
    B, dim = trans.shape
    K = a.shape[0]
    dev = trans.device
    want = {
        "trans": (trans, torch.float32, (B, dim)),
        "rot": (rot, torch.float32, (B, dim, dim)),
        "linvel": (linvel, torch.float32, (B, dim)),
        "angvel": (angvel, torch.float32, (B,) if dim == 2 else (B, 3)),
        "inv_mass": (inv_mass, torch.float32, (B,)),
        "inv_inertia": (inv_inertia, torch.float32,
                        (B, 1) if dim == 2 else (B, 3)),
        "a": (a, torch.int32, (K,)),
        "b": (b, torch.int32, (K,)),
        "p": (p, torch.float32, (K, dim)),
        "n": (n, torch.float32, (K, dim)),
        "count": (count, torch.int32, ()),
    }
    if dim not in (2, 3):
        raise ValueError(f"solve_contacts: dim must be 2 or 3, got {dim}")
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype:
            raise TypeError(f"solve_contacts: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"solve_contacts: {name} must be {shape}, "
                             f"got {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"solve_contacts: {name} must lie on {dev}")
    return B, K, dim


def solve_contacts(trans, rot, linvel, angvel, inv_mass, inv_inertia, a, b,
                   p, n, count, restitution: float, friction: float,
                   iterations: int):
    """Sequential-impulse contact solve (module note); returns the new
    ``(linvel, angvel)``. CPU tensors run :func:`solve_contacts_plain`;
    CUDA tensors launch the kernel or raise."""
    B, K, dim = _check(trans, rot, linvel, angvel, inv_mass, inv_inertia,
                       a, b, p, n, count)
    dev = trans.device
    if dev.type == "cpu":
        return solve_contacts_plain(trans, rot, linvel, angvel, inv_mass,
                                    inv_inertia, a, b, p, n, count,
                                    restitution, friction, iterations)
    if dev.type != "cuda":
        raise RuntimeError(f"solve_contacts runs on CPU (plain) or CUDA "
                           f"(kernel) tensors, got {dev}")
    if K > MAX_CONTACTS:
        raise ValueError(f"solve_contacts: {K} contacts, the kernel takes "
                         f"at most {MAX_CONTACTS}")
    lin = linvel.contiguous().clone()
    ang = angvel.contiguous().clone()
    ins = [t.contiguous() for t in (trans, rot, inv_mass, inv_inertia, a, b,
                                     p, n, count)]
    from . import _build

    _build.launch(LAUNCHES, "rigid_solve", "salva_rigid_solve",
                  *[t.data_ptr() for t in ins], lin.data_ptr(),
                  ang.data_ptr(), B, K, dim, int(iterations),
                  float(restitution), float(friction), device=dev)
    return lin, ang
