"""SE(3) pose-graph residuals with their Jacobians.

Counterpart of the residuals of the JAX package's `ops/spa_3d.py`
(spa_cost_function_3d.h, rotation_cost_function_3d.h,
acceleration_cost_function_3d.h): `constraint_residual_3d` (l.110),
`rotation_residual_3d` (l.98) and `acceleration_residual_3d` (l.78). Each
takes its arguments with leading batch dimensions that broadcast. The dense
solver `solve_spa_3d` of that module is not ported; the pose graph solves
with the Schur-complement solver of `parallel/schur_spa_3d.py`, whose plain
twin takes the Jacobians below.

The Jacobians are those of the JAX program, `jax.jacfwd` of each residual
through the retraction t + d[0:3], normalize(q exp(d[3:6])) at zero tangent
(`parallel/schur_spa_3d.py:_bin_local`, `_rot_local`, `_acc_local`,
l.131-151): forward-mode derivatives with `torch.func.jacfwd`, batched with
`torch.func.vmap`.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from cartographer_tpu_torch.transform import quaternion as quat


def acceleration_residual_3d(ti, tj, tk, qj, delta_v, dt1, dt2, weight, gravity, calib_q):
    """AccelerationCostFunction3D: w * (R_j (calib delta_v) - g dt_sum z
    - ((tk - tj) / dt2 - (tj - ti) / dt1)), dt_sum the mean interval."""
    dt_sum = 0.5 * (dt1 + dt2)
    second_diff = (tk - tj) / dt2[..., None] - (tj - ti) / dt1[..., None]
    imu_dv = quat.rotate_expanded(qj, quat.rotate_expanded(calib_q, delta_v))
    gz = (gravity * dt_sum)[..., None] * torch.tensor([0.0, 0.0, 1.0], device=ti.device)
    return weight[..., None] * ((imu_dv - gz) - second_diff)


def rotation_residual_3d(qi, qj, delta_q, calib_q, weight):
    """RotationCostFunction3D: the vector part of
    q_j^-1 q_i calib delta_q calib^-1, times the weight."""
    inner = quat.multiply(delta_q, quat.conjugate(calib_q))
    err = quat.multiply(quat.conjugate(qj),
                        quat.multiply(qi, quat.multiply(calib_q, inner)))
    return weight[..., None] * err[..., 1:4]


def constraint_residual_3d(ta, qa, tb, qb, rel_t, rel_q, tw, rw):
    """6-residual of one SE(3) constraint: [R_a^T (t_b - t_a) - rel_t] tw,
    log(rel_q^-1 q_a^-1 q_b) rw."""
    local_t = quat.rotate_expanded(quat.conjugate(qa), tb - ta)
    e_t = (local_t - rel_t) * tw[..., None]
    dq = quat.multiply(quat.conjugate(rel_q), quat.multiply(quat.conjugate(qa), qb))
    return torch.cat([e_t, quat.to_axis_angle(dq) * rw[..., None]], -1)


def _retract_q(q, d6):
    return quat.normalize(quat.multiply(q, quat.from_axis_angle(d6[..., 3:6])))


def bin_local(da, db, ta, qa, tb, qb, rel_t, rel_q, tw, rw):
    return constraint_residual_3d(ta + da[0:3], _retract_q(qa, da), tb + db[0:3],
                                  _retract_q(qb, db), rel_t, rel_q, tw, rw)


def rot_local(d_i, d_j, d_t, qi, qj, cq, dq, w):
    return rotation_residual_3d(_retract_q(qi, d_i), _retract_q(qj, d_j), dq,
                                _retract_q(cq, d_t), w)


def acc_local(d_i, d_j, d_k, d_t, ti, tj, tk, qj, gv, cq, dv, dt1, dt2, w):
    return acceleration_residual_3d(ti + d_i[0:3], tj + d_j[0:3], tk + d_k[0:3],
                                    _retract_q(qj, d_j), dv, dt1, dt2, w, gv + d_t[0],
                                    _retract_q(cq, d_t))


def _jacobians(fn, num_tangents: int, *args):
    """(residuals (E, R), [d r / d tangent_n (E, R, 6)]) of fn(tangents...,
    data...) at zero tangents, batched over the leading axis of `args`: one
    forward-mode pass over the tangents stacked."""
    def stacked(d, *data):
        r = fn(*d.reshape(num_tangents, 6), *data)
        return r, r

    zero = args[0].new_zeros(6 * num_tangents)
    in_dims = (None,) + (0,) * len(args)
    jac, r = vmap(jacfwd(stacked, has_aux=True), in_dims=in_dims)(zero, *args)
    # Tangents through the small-angle branches come back in float64.
    return r, list(jac.to(r.dtype).split(6, dim=-1))


def constraint_jacobians_3d(ta, qa, tb, qb, rel_t, rel_q, tw, rw):
    """-> (r (C, 6), [J_a, J_b] (C, 6, 6)) of the binary constraint."""
    return _jacobians(bin_local, 2, ta, qa, tb, qb, rel_t, rel_q, tw, rw)


def rotation_jacobians_3d(qi, qj, cq, dq, w):
    """-> (r (R, 3), [J_i, J_j, J_traj] (R, 3, 6)) of the gyro term."""
    return _jacobians(rot_local, 3, qi, qj, cq, dq, w)


def acceleration_jacobians_3d(ti, tj, tk, qj, gv, cq, dv, dt1, dt2, w):
    """-> (r (A, 3), [J_i, J_j, J_k, J_traj] (A, 3, 6)) of the triplet."""
    return _jacobians(acc_local, 4, ti, tj, tk, qj, gv, cq, dv, dt1, dt2, w)
