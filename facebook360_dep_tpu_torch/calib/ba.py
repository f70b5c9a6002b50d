"""Bundle adjustment: Levenberg-Marquardt with a Schur complement, in float64
on the rig's device. The port of ``facebook360_dep_tpu/calib/ba.py``.

The reference solves rig calibration with Ceres (numeric-diff functors +
Huber loss + parameter locking; ``calibration/GeometricCalibration.h:53-384``,
``.cpp:995-1205``). Here, as in the JAX package:

- per-observation residuals and exact Jacobians by forward-mode AD: each
  observation depends only on its own 12 camera and 3 point parameters, so
  15 JVPs over the whole (K,)-batched residual give every (2, 12) and (2, 3)
  block (``torch.func.jvp`` under ``vmap`` over the 15 tangents);
- the point blocks eliminated by a Schur complement: H_pp is block-diagonal
  3x3 per trace, the camera system is dense and small;
- Huber robustness by IRLS reweighting (delta = 1, ceres::HuberLoss(1.0));
- locking and group sharing by a free mask over the flat camera parameter
  vector and per-camera slot maps (GeometricCalibration.cpp:1108-1140);
- the reference-camera gauge (baseline radius lock) as a retraction after
  each step.

The H100 runs float64 natively, so nothing here is pinned to the host: the
solve runs where the rig's tensors are. The JAX package pads the
observations to shape buckets for XLA's compile cache; a padded row has a
zero residual scale, so the port solves the unpadded problem.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import camera as cam

HUBER_DELTA = 1.0
F64 = torch.float64


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices [v]x."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], -2)


def _skew_squared(v: torch.Tensor) -> torch.Tensor:
    """[v]x @ [v]x = v v^T - |v|^2 I."""
    sq = (v * v).sum(-1)[..., None, None]
    return v[..., :, None] * v[..., None, :] - sq * torch.eye(3, dtype=v.dtype, device=v.device)


def rodrigues(rotvec: torch.Tensor) -> torch.Tensor:
    """Angle-axis (..., 3) -> rotation matrices (..., 3, 3) (Eigen AngleAxis
    convention).

    Below an angle of 1e-12 it is the series I + [v]x + [v]x^2 / 2, whose
    derivative at 0 is the skew generator. (The JAX package returns the
    constant identity there, so its Jacobian at rotvec = 0 is zero.) The
    other branch sees a safe angle, so that its tangents stay finite.
    """
    sq = (rotvec * rotvec).sum(-1)
    small = sq < 1e-24
    angle = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))[..., None, None]
    k = rotvec / angle[..., 0]
    eye = torch.eye(3, dtype=rotvec.dtype, device=rotvec.device)
    # [k]x^2 = k k^T - |k|^2 I, elementwise rather than a batch of 3x3 products
    r = eye + torch.sin(angle) * _skew(k) + (1 - torch.cos(angle)) * _skew_squared(k)
    return torch.where(small[..., None, None], eye + _skew(rotvec) + 0.5 * _skew_squared(rotvec), r)


def rotation_to_rotvec(r) -> np.ndarray:
    """Rotation matrix (3, 3) -> angle-axis (3,), on the host."""
    from scipy.spatial.transform import Rotation

    if isinstance(r, torch.Tensor):
        r = r.detach().cpu().numpy()
    return Rotation.from_matrix(np.asarray(r, np.float64)).as_rotvec()


class Problem(NamedTuple):
    """A calibration problem over one rig.

    Camera parameters are flattened into one global vector theta:
      [positions (N*3) | rotvecs (N*3) | principals (P*2) | focals (P) |
       distortions (D*3)]
    with per-camera index maps pf_idx (camera -> principal/focal slot) and
    d_idx (camera -> distortion slot) implementing group sharing.
    """

    base_cams: cam.Camera  # stacked (N,), float64 on the solve's device
    pf_idx: np.ndarray  # (N,)
    d_idx: np.ndarray  # (N,)
    n_cams: int
    n_pf: int
    n_d: int

    obs_cam: torch.Tensor  # (K,) int64
    obs_point: torch.Tensor  # (K,) int64
    obs_pixel: torch.Tensor  # (K, 2) float64
    obs_weight: torch.Tensor  # (K,) float64; residual scale 1/sqrt(w)
    n_obs: int = -1

    @property
    def theta_size(self) -> int:
        return 6 * self.n_cams + 3 * self.n_pf + 3 * self.n_d

    @property
    def device(self) -> torch.device:
        return self.obs_pixel.device

    def slices(self):
        n, p, d = self.n_cams, self.n_pf, self.n_d
        return {
            "position": (0, 3 * n),
            "rotvec": (3 * n, 6 * n),
            "principal": (6 * n, 6 * n + 2 * p),
            "focal": (6 * n + 2 * p, 6 * n + 3 * p),
            "distortion": (6 * n + 3 * p, 6 * n + 3 * p + 3 * d),
        }


def pack_theta(problem: Problem, rig: cam.Rig) -> torch.Tensor:
    """Initial parameter vector from a rig (group slots take the first member)."""
    cams = cam.camera_to_numpy(rig.cameras)
    n = problem.n_cams
    positions = cams.position.reshape(-1)
    rotvecs = np.stack([rotation_to_rotvec(cams.rotation[i]) for i in range(n)]).reshape(-1)
    principals = np.zeros((problem.n_pf, 2))
    focals = np.zeros(problem.n_pf)
    distortions = np.zeros((problem.n_d, 3))
    for i in range(n):
        principals[problem.pf_idx[i]] = cams.principal[i]
        focals[problem.pf_idx[i]] = cams.focal[i][0]  # scalar focal (x, -x)
        distortions[problem.d_idx[i]] = cams.distortion[i]
    theta = np.concatenate([positions, rotvecs, principals.reshape(-1), focals, distortions.reshape(-1)])
    return torch.as_tensor(theta, dtype=F64, device=problem.device)


def unpack_rig(problem: Problem, rig: cam.Rig, theta: torch.Tensor) -> cam.Rig:
    """The rig with theta's parameters (float64, on theta's device)."""
    s = problem.slices()
    n = problem.n_cams
    theta = torch.as_tensor(theta, dtype=F64, device=problem.device)
    pf = torch.as_tensor(problem.pf_idx, device=theta.device)
    di = torch.as_tensor(problem.d_idx, device=theta.device)
    positions = theta[s["position"][0]:s["position"][1]].reshape(n, 3)
    rotvecs = theta[s["rotvec"][0]:s["rotvec"][1]].reshape(n, 3)
    principals = theta[s["principal"][0]:s["principal"][1]].reshape(problem.n_pf, 2)[pf]
    focals = theta[s["focal"][0]:s["focal"][1]][pf]
    distortions = theta[s["distortion"][0]:s["distortion"][1]].reshape(problem.n_d, 3)[di]
    dist_np = distortions.cpu().numpy()
    dmax = torch.as_tensor([cam._solve_distortion_max(d) for d in dist_np], dtype=F64, device=theta.device)
    cams = rig.cameras.to(theta.device, F64)._replace(
        position=positions,
        rotation=rodrigues(rotvecs),
        principal=principals,
        focal=torch.stack([focals, -focals], -1),
        distortion=distortions,
        distortion_max=dmax,
    )
    return rig._replace(cameras=cams)


def make_problem(
    rig: cam.Rig,
    obs_cam,
    obs_point,
    obs_pixel,
    obs_weight=None,
    shared_principal_and_focal: bool = False,
    shared_distortion: bool = True,
) -> Problem:
    """The problem on the rig's device."""
    n = len(rig.ids)
    groups = list(dict.fromkeys(rig.groups))  # unique, in order
    g_idx = np.asarray([groups.index(g) for g in rig.groups])
    pf_idx = g_idx if shared_principal_and_focal else np.arange(n)
    d_idx = g_idx if shared_distortion else np.arange(n)
    k = len(obs_cam)
    dev = rig.cameras.position.device
    if obs_weight is None:
        obs_weight = np.ones(k)
    return Problem(
        base_cams=rig.cameras.to(dev, F64),
        pf_idx=np.asarray(pf_idx),
        d_idx=np.asarray(d_idx),
        n_cams=n,
        n_pf=int(pf_idx.max()) + 1,
        n_d=int(d_idx.max()) + 1,
        obs_cam=torch.as_tensor(np.asarray(obs_cam), dtype=torch.int64, device=dev),
        obs_point=torch.as_tensor(np.asarray(obs_point), dtype=torch.int64, device=dev),
        obs_pixel=torch.as_tensor(np.asarray(obs_pixel), dtype=F64, device=dev),
        obs_weight=torch.as_tensor(np.asarray(obs_weight), dtype=F64, device=dev),
        n_obs=k,
    )


def _per_obs_params(problem: Problem, theta: torch.Tensor):
    """Each observation's camera-side parameters and their 12 global column
    indices in theta: position 3, rotvec 3, principal 2, focal 1, distortion 3."""
    s = problem.slices()
    ci = problem.obs_cam
    pf = torch.as_tensor(problem.pf_idx, device=ci.device)[ci]
    di = torch.as_tensor(problem.d_idx, device=ci.device)[ci]
    ar = torch.arange(3, device=ci.device)
    pos_cols = s["position"][0] + 3 * ci[:, None] + ar
    rot_cols = s["rotvec"][0] + 3 * ci[:, None] + ar
    pri_cols = s["principal"][0] + 2 * pf[:, None] + ar[:2]
    foc_cols = s["focal"][0] + pf[:, None]
    dist_cols = s["distortion"][0] + 3 * di[:, None] + ar
    cols = torch.cat([pos_cols, rot_cols, pri_cols, foc_cols, dist_cols], dim=1)  # (K, 12)
    params = (theta[pos_cols], theta[rot_cols], theta[pri_cols], theta[foc_cols][:, 0], theta[dist_cols])
    return params, cols


def _residual_fn(problem: Problem):
    """f(pos, rot, pri, foc, dist, world) -> (K, 2) weighted residuals of the
    (K,)-batched observation cameras (makeCamera, GeometricCalibration.h:17-32;
    the distortion clamp is dropped inside the solver, as Ceres' numeric
    functor behaves identically in range)."""
    base = problem.base_cams.index(problem.obs_cam)
    wscale = (1.0 / torch.sqrt(problem.obs_weight))[:, None]
    pixel = problem.obs_pixel

    def res(pos, rot, pri, foc, dist, world):
        c = base._replace(
            position=pos,
            rotation=rodrigues(rot),
            principal=pri,
            focal=torch.stack([foc, -foc], -1),
            distortion=dist,
            distortion_max=torch.full_like(foc, float("inf")),
        )
        return (cam.pixel(c, world) - pixel) * wscale

    return res


def _args(problem: Problem, theta, points):
    params, cols = _per_obs_params(problem, theta)
    return params + (points[problem.obs_point],), cols


def residuals(problem: Problem, theta, points) -> torch.Tensor:
    """(K, 2) weighted residuals only — no Jacobians (for cost evaluation)."""
    args, _ = _args(problem, theta, points)
    return _residual_fn(problem)(*args)


# tangent basis of the 15 per-observation parameters, in the order of
# _per_obs_params followed by the point's 3 coordinates
_ARG_WIDTHS = (3, 3, 2, 1, 3, 3)


def residuals_and_jacobians(problem: Problem, theta, points):
    """(K, 2) residuals plus each observation's exact Jacobians with respect
    to its 12 camera parameters (K, 2, 12) and its point (K, 2, 3): 15 JVPs,
    batched by ``vmap`` over the tangents."""
    args, cols = _args(problem, theta, points)
    res = _residual_fn(problem)
    k = cols.shape[0]
    eye = torch.eye(sum(_ARG_WIDTHS), dtype=F64, device=theta.device)
    tangents, start = [], 0
    for a, width in zip(args, _ARG_WIDTHS):
        t = eye[:, None, start:start + width].expand(-1, k, width)
        tangents.append(t[..., 0] if a.ndim == 1 else t)
        start += width

    def jvp(*t):
        return torch.func.jvp(res, args, t)

    r, jac = torch.func.vmap(jvp, out_dims=(None, 0))(*tangents)  # jac (15, K, 2)
    jac = jac.permute(1, 2, 0)
    return r, jac[..., :12], jac[..., 12:], cols


def huber_weights(r_norm, delta=HUBER_DELTA):
    """IRLS weights for ceres::HuberLoss: w = 1 inside, delta/|r| outside."""
    return torch.where(r_norm <= delta, 1.0, delta / torch.clamp(r_norm, min=1e-30))


def huber_cost(r_norm, delta=HUBER_DELTA):
    return torch.where(r_norm <= delta, r_norm * r_norm, 2 * delta * r_norm - delta * delta)


def lm_step(problem: Problem, theta, points, lam, free_mask, robust=True):
    """One Levenberg-Marquardt step via the Schur complement. Returns
    (new_theta, new_points, cost at the old parameters)."""
    m = points.shape[0]
    n = problem.theta_size
    r, j_cam, j_pt, cols = residuals_and_jacobians(problem, theta, points)
    r_norm = torch.linalg.vector_norm(r, dim=-1)
    w = huber_weights(r_norm) if robust else torch.ones_like(r_norm)
    sw = torch.sqrt(w)[:, None]
    r_w = r * sw
    j_cam = j_cam * sw[..., None]
    j_pt = j_pt * sw[..., None]
    j_cam = j_cam * free_mask[cols][:, None, :]  # zero the locked columns

    pid = problem.obs_point
    # H_pp (M, 3, 3), b_p (M, 3)
    h_pp = points.new_zeros((m, 3, 3)).index_add_(0, pid, torch.einsum("kri,krj->kij", j_pt, j_pt))
    b_p = points.new_zeros((m, 3)).index_add_(0, pid, -torch.einsum("kri,kr->ki", j_pt, r_w))
    h_pp_diag = torch.diagonal(h_pp, dim1=-2, dim2=-1) + 1e-8
    h_pp_inv = torch.linalg.inv(h_pp + lam * torch.diag_embed(h_pp_diag))

    # dense camera system
    jtj = torch.einsum("kri,krj->kij", j_cam, j_cam)  # (K, 12, 12)
    h_cc = theta.new_zeros(n * n).index_add_(
        0, (cols[:, :, None] * n + cols[:, None, :]).reshape(-1), jtj.reshape(-1)).view(n, n)
    b_c = theta.new_zeros(n).index_add_(0, cols.reshape(-1), -torch.einsum("kri,kr->ki", j_cam, r_w).reshape(-1))
    # W_p = sum over the point's observations of J_cam^T J_pt, dense (M, n, 3)
    w_ct = torch.einsum("kri,krj->kij", j_cam, j_pt)  # (K, 12, 3)
    w_full = points.new_zeros((m * n, 3)).index_add_(
        0, (pid[:, None] * n + cols).reshape(-1), w_ct.reshape(-1, 3)).view(m, n, 3)

    # Schur: S = H_cc + lam*diag - sum_p W_p Hpp^-1 W_p^T
    w_hinv = torch.einsum("mic,mcd->mid", w_full, h_pp_inv)
    s_mat = h_cc - torch.einsum("mid,mjd->ij", w_hinv, w_full)
    rhs = b_c - torch.einsum("mid,md->i", w_hinv, b_p)
    s_mat = s_mat + torch.diag(lam * (torch.diagonal(h_cc) + 1e-8))
    # locked rows/cols: identity on locked entries
    s_mat = torch.where(free_mask[:, None] & free_mask[None, :], s_mat, 0.0)
    s_mat = s_mat + torch.diag((~free_mask).to(s_mat.dtype))
    rhs = rhs * free_mask

    delta_c = torch.linalg.solve(s_mat, rhs)
    delta_p = torch.einsum("mcd,md->mc", h_pp_inv, b_p - torch.einsum("mic,i->mc", w_full, delta_c))

    cost = torch.sum(huber_cost(r_norm)) if robust else torch.sum(r_norm**2)
    return theta + delta_c, points + delta_p, cost


def total_cost(problem: Problem, theta, points, robust=True) -> torch.Tensor:
    r_norm = torch.linalg.vector_norm(residuals(problem, theta, points), dim=-1)
    return torch.sum(huber_cost(r_norm)) if robust else torch.sum(r_norm**2)


def residual_norms(problem: Problem, theta, points) -> np.ndarray:
    """Per-observation reprojection error norms, on the host."""
    return torch.linalg.vector_norm(residuals(problem, theta, points), dim=-1).cpu().numpy()


def solve_lm(
    problem: Problem,
    theta0,
    points0,
    free_mask,
    robust: bool = True,
    max_iterations: int = 25,
    lam0: float = 1e-4,
    baseline_lock: tuple | None = None,
):
    """LM with adaptive damping, on the problem's device. Returns (theta,
    points, cost): float64 tensors there and a float.
    ``baseline_lock=(ref_idx, rel_idx, radius)`` retracts the relative camera
    back onto the baseline sphere (the reference's
    SphericalReprojectionFunctor gauge)."""
    dev = problem.device
    theta = torch.as_tensor(theta0, dtype=F64, device=dev)
    points = torch.as_tensor(points0, dtype=F64, device=dev)
    free_mask = torch.as_tensor(free_mask, dtype=torch.bool, device=dev)
    lam = lam0
    cost = float(total_cost(problem, theta, points, robust))
    for _ in range(max_iterations):
        new_theta, new_points, _ = lm_step(problem, theta, points, lam, free_mask, robust=robust)
        if baseline_lock is not None:
            new_theta = _retract_baseline(problem, new_theta, *baseline_lock)
        new_cost = float(total_cost(problem, new_theta, new_points, robust))
        if new_cost < cost:
            theta, points, cost = new_theta, new_points, new_cost
            lam = max(lam * 0.3, 1e-12)
        else:
            lam = min(lam * 4.0, 1e8)
            if lam >= 1e8:
                break
    return theta, points, cost


def _retract_baseline(problem: Problem, theta, ref_idx, rel_idx, radius):
    s0 = problem.slices()["position"][0]
    ref = theta[s0 + 3 * ref_idx:s0 + 3 * ref_idx + 3]
    v = theta[s0 + 3 * rel_idx:s0 + 3 * rel_idx + 3] - ref
    v = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-30) * radius
    out = theta.clone()
    out[s0 + 3 * rel_idx:s0 + 3 * rel_idx + 3] = ref + v
    return out


# ---------------------------------------------------------------------------
# Triangulation (TriangulationFunctor, GeometricCalibration.h:216-265)
# ---------------------------------------------------------------------------


def triangulate(
    rig_cams: cam.Camera,  # stacked (N,)
    obs_cam,  # (M, max_obs) padded camera indices
    obs_pixel,  # (M, max_obs, 2)
    obs_valid,  # (M, max_obs) bool
    iterations: int = 10,
    force_in_front: bool = True,
) -> torch.Tensor:
    """Gauss-Newton on the inverse-world parametrization, batched over
    traces, in float64 on the cameras' device. Returns (M, 3) points there.

    inv = world / |world|^2 keeps the solver from overshooting behind the rig
    (GeometricCalibration.h:216-231). Initialized from the average ray point
    at 10 m (averageAtDistance, :269-275). Each iteration's (M, 2 max_obs, 3)
    Jacobian is 3 JVPs.
    """
    dev = rig_cams.position.device
    ci = torch.as_tensor(np.asarray(obs_cam), dtype=torch.int64, device=dev)
    px = torch.as_tensor(np.asarray(obs_pixel), dtype=F64, device=dev)
    valid = torch.as_tensor(np.asarray(obs_valid), dtype=torch.bool, device=dev)
    c = rig_cams.to(dev, F64).index(ci)  # batch (M, max_obs)
    ok = valid.to(F64)[..., None]
    m = ci.shape[0]

    def avg_at_distance(distance):
        pts = cam.rig_point(c, px, distance) * ok
        return pts.sum(1) / torch.clamp(valid.sum(1), min=1)[:, None]

    def world_of(inv):
        return inv / torch.clamp((inv * inv).sum(-1, keepdim=True), min=1e-30)

    def r_fn(inv):
        return ((cam.pixel(c, world_of(inv)[:, None, :]) - px) * ok).reshape(m, -1)

    world0 = avg_at_distance(10.0)  # kInitialDistance
    inv = world_of(world0)
    basis = torch.eye(3, dtype=F64, device=dev)[:, None, :].expand(3, m, 3)
    eye = torch.eye(3, dtype=F64, device=dev)
    for _ in range(iterations):
        r, j = torch.func.vmap(lambda t: torch.func.jvp(r_fn, (inv,), (t,)), out_dims=(None, 0))(basis)
        j = j.permute(1, 2, 0)  # (M, 2 max_obs, 3)
        h = j.transpose(1, 2) @ j + 1e-12 * eye
        inv = inv - torch.linalg.solve(h, (j.transpose(1, 2) @ r[..., None]))[..., 0]
    world = world_of(inv)

    if force_in_front:
        any_behind = (cam.is_behind(c, world[:, None, :]) & valid).any(1)
        world = torch.where(any_behind[:, None], avg_at_distance(cam.KNEAR_INFINITY), world)
    return world
