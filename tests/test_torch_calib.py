"""The port's rig calibration (``calib/ba``, ``calib/calibration``,
``calib/rig_tools`` and the camera additions) against the JAX package's, in
float64 on the CPU, on numpy inputs made from seeds.

The rigs are the four camera types with radial distortion
(``torch_parity.ring_rig(mixed=True)``) and the JAX tests' FTHETA rig, each
turned by one common rotation: the JAX ``rodrigues`` has a zero Jacobian at
rotvec = 0 (it returns a constant identity below an angle of 1e-12), so on
an unrotated rig its bundle adjustment cannot turn camera 0, while the
port's can. With every rotvec away from 0 both packages solve the same
problem. ``test_rodrigues_jacobian_at_zero`` shows the difference.

Tolerances: single functions in float64 agree to 1e-10 relative (measured
1e-15 to 1e-12); the end-to-end solves sum their scatter-adds in another
order than XLA, and agree to 1e-7 (measured 1e-13).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from facebook360_dep_tpu.calib import ba as jba
from facebook360_dep_tpu.calib import calibration as jcal
from facebook360_dep_tpu.calib import rig_tools as jrt
from facebook360_dep_tpu.core import camera as jcam
from facebook360_dep_tpu.render import synthetic as jsyn
from facebook360_dep_tpu_torch.calib import ba as tba
from facebook360_dep_tpu_torch.calib import calibration as tcal
from facebook360_dep_tpu_torch.calib import rig_tools as trt
from facebook360_dep_tpu_torch.core import camera as tcam

from torch_parity import port_rig, ring_rig

TURN = np.asarray([0.3, -0.2, 0.5])  # the common rotation of every test rig
FIELDS = ("position", "rotation", "principal", "focal", "distortion", "distortion_max")


def turned(rig):
    from scipy.spatial.transform import Rotation

    return jrt.transform_rig(rig, Rotation.from_rotvec(TURN).as_matrix(), np.zeros(3), 1.0)


def np_cams(rig):
    """A rig's camera fields as float64 numpy, from either package."""
    if isinstance(rig.cameras.position, torch.Tensor):
        return tcam.camera_to_numpy(rig.cameras)
    return jax.tree.map(lambda a: np.asarray(a, np.float64 if np.asarray(a).dtype.kind == "f" else None),
                        rig.cameras)


def assert_rigs_close(got, want, rtol, atol=0.0):
    assert got.ids == want.ids and got.groups == want.groups
    a, b = np_cams(got), np_cams(want)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=rtol, atol=atol, err_msg=f)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))


@pytest.fixture(scope="module")
def mixed():
    """(JAX rig, port rig): 5 cameras of the four types with distortion, 160x120, turned."""
    jrig = turned(ring_rig(jcam, "FTHETA", n=5, resolution=(160, 120), ring_radius=0.2, mixed=True))
    return jrig, port_rig(tcam, jrig)


@pytest.fixture(scope="module")
def traces(mixed):
    """Artificial observations of the mixed rig (200 points, 0.3 px noise),
    assembled and triangulated by the JAX package."""
    jrig, _ = mixed
    feats, overlaps = jcal.generate_artificial_points(jrig, count=200, min_dist=1.0, error_stddev=0.3, seed=3)
    oc, ot, op, nt = jcal.assemble_traces(feats, overlaps, jrig)
    points = jcal.triangulate_traces(jrig, oc, ot, op, nt)
    return feats, overlaps, oc, ot, op, nt, points


def problems(mixed, traces, **kw):
    jrig, trig = mixed
    _, _, oc, ot, op, _, _ = traces
    return jba.make_problem(jrig, oc, ot, op, **kw), tba.make_problem(trig, oc, ot, op, **kw)


# ---------------------------------------------------------------------------
# rotations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rotvec", [[0.1, -0.2, 0.3], [2.5, 0.4, -1.0], [1e-7, 0.0, 0.0], [0.0, 3e-13, 0.0]])
def test_rodrigues_matches_jax(rotvec):
    rv = np.asarray(rotvec)
    got = tba.rodrigues(torch.as_tensor(rv)).numpy()
    np.testing.assert_allclose(got, np.asarray(jba.rodrigues(jnp.asarray(rv))), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got @ got.T, np.eye(3), atol=1e-12)


def test_rodrigues_batched_and_rotvec_roundtrip():
    rvs = np.random.RandomState(0).uniform(-1.5, 1.5, (6, 3))
    got = tba.rodrigues(torch.as_tensor(rvs)).numpy()
    for rv, r in zip(rvs, got):
        np.testing.assert_allclose(r, np.asarray(jba.rodrigues(jnp.asarray(rv))), atol=1e-14)
        np.testing.assert_allclose(tba.rotation_to_rotvec(r), jba.rotation_to_rotvec(r), atol=1e-14)
        np.testing.assert_allclose(tba.rotation_to_rotvec(torch.as_tensor(r)), rv, atol=1e-12)


def test_rodrigues_jacobian_at_zero():
    """At rotvec = 0 the port's Jacobian is the analytic one, dR/dv_i =
    [e_i]x; the JAX package's is zero (its fault, not copied)."""
    zero = torch.zeros(3, dtype=torch.float64)
    jac = torch.func.jacfwd(tba.rodrigues)(zero).permute(2, 0, 1)  # (i, 3, 3)
    analytic = tba._skew(torch.eye(3, dtype=torch.float64))
    assert torch.equal(jac, analytic)
    assert not np.asarray(jax.jacfwd(jba.rodrigues)(jnp.zeros(3))).any()


@pytest.mark.parametrize("rotvec", [[0.1, -0.2, 0.3], [1e-7, 2e-7, -1e-7], [2.0, -1.0, 0.5]])
def test_rodrigues_jacobian_matches_jax_away_from_zero(rotvec):
    rv = np.asarray(rotvec)
    got = torch.func.jacfwd(tba.rodrigues)(torch.as_tensor(rv)).numpy()
    want = np.asarray(jax.jacfwd(jba.rodrigues)(jnp.asarray(rv)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


# ---------------------------------------------------------------------------
# camera additions
# ---------------------------------------------------------------------------


def test_rig_near_infinity_and_is_behind(mixed):
    jrig, trig = mixed
    rng = np.random.RandomState(1)
    pix = rng.uniform(0, 1, (40, 2)) * np.asarray([160, 120])
    pts = rng.uniform(-3, 3, (40, 3))
    for i in range(len(jrig.ids)):
        jc, tc = jrig.camera(i), trig.camera(i)
        np.testing.assert_allclose(tcam.rig_near_infinity(tc, torch.as_tensor(pix)).numpy(),
                                   np.asarray(jcam.rig_near_infinity(jc, jnp.asarray(pix))), rtol=1e-10, atol=1e-8)
        np.testing.assert_array_equal(tcam.is_behind(tc, torch.as_tensor(pts)).numpy(),
                                      np.asarray(jcam.is_behind(jc, jnp.asarray(pts))))
    batched = tcam.is_behind(trig.cameras, torch.as_tensor(pts)[None]).numpy()
    assert batched.shape == (len(jrig.ids), 40) and batched.any() and not batched.all()


def test_rescale_rig(mixed):
    jrig, trig = mixed
    assert_rigs_close(tcam.rescale_rig(trig, [640, 480]), jcam.rescale_rig(jrig, [640, 480]), rtol=1e-15)


@pytest.mark.parametrize("amounts", [dict(rot_amount=0.02), dict(pos_amount=0.01, principal_amount=2.0),
                                     dict(rot_amount=0.01, focal_amount=3.0)])
def test_perturb_cameras_same_draws(mixed, amounts):
    jrig, trig = mixed
    got = tcam.perturb_cameras(trig, seed=9, **amounts)
    assert_rigs_close(got, jcam.perturb_cameras(jrig, seed=9, **amounts), rtol=1e-14, atol=1e-14)
    assert got.cameras.position.dtype == torch.float64


# ---------------------------------------------------------------------------
# problem building
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shared", [False, True])
def test_make_problem_pack_unpack(mixed, traces, shared):
    jrig, trig = mixed
    groups = ("a", "b", "a", "b", "c") if shared else jrig.groups
    jrig, trig = jrig._replace(groups=groups), trig._replace(groups=groups)
    kw = dict(shared_principal_and_focal=shared, shared_distortion=True)
    jp, tp = problems((jrig, trig), traces, **kw)
    assert (tp.n_cams, tp.n_pf, tp.n_d, tp.theta_size) == (jp.n_cams, jp.n_pf, jp.n_d, jp.theta_size)
    np.testing.assert_array_equal(tp.pf_idx, jp.pf_idx)
    np.testing.assert_array_equal(tp.d_idx, jp.d_idx)
    k = tp.n_obs
    np.testing.assert_array_equal(tp.obs_cam.numpy(), np.asarray(jp.obs_cam)[:k])
    np.testing.assert_array_equal(tp.obs_pixel.numpy(), np.asarray(jp.obs_pixel)[:k])
    theta = tba.pack_theta(tp, trig)
    np.testing.assert_allclose(theta.numpy(), jba.pack_theta(jp, jrig), rtol=0, atol=1e-15)
    moved = theta.numpy() + np.random.RandomState(2).uniform(-1e-3, 1e-3, theta.shape)
    assert_rigs_close(tba.unpack_rig(tp, trig, torch.as_tensor(moved)), jba.unpack_rig(jp, jrig, moved),
                      rtol=1e-12, atol=1e-14)


# each pass kind: (options, pass index)
PASSES = {
    "defaults, pass 0": (dict(), 0),
    "defaults, pass 1": (dict(), 1),
    "positions free, pass 0": (dict(lock_positions=False), 0),
    "positions free, pass 2, reference cam2": (dict(lock_positions=False, reference_camera="cam2"), 2),
    "rotations and principals locked": (dict(lock_rotations=True, lock_principals=True), 1),
    "focal locked, distortion free": (dict(lock_focal=True, lock_distortion=False), 3),
}


@pytest.mark.parametrize("kind", sorted(PASSES))
def test_free_mask(mixed, traces, kind):
    kw, pass_idx = PASSES[kind]
    jrig, _ = mixed
    jp, tp = problems(mixed, traces)
    ref_idx = jrig.ids.index(kw["reference_camera"]) if "reference_camera" in kw else 0
    got = tcal._free_mask(tp, tcal.CalibrationOptions(**kw), pass_idx, ref_idx)
    np.testing.assert_array_equal(got, jcal._free_mask(jp, jcal.CalibrationOptions(**kw), pass_idx, ref_idx))


# ---------------------------------------------------------------------------
# residuals, Jacobians, LM
# ---------------------------------------------------------------------------


def test_residuals_and_jacobians(mixed, traces):
    jrig, trig = mixed
    points = traces[-1]
    jp, tp = problems(mixed, traces)
    theta = jba.pack_theta(jp, jrig)
    k = tp.n_obs
    jr, jjc, jjp, jcols = (np.asarray(a)[:k] for a in jba.residuals_and_jacobians(jp, jnp.asarray(theta),
                                                                                   jnp.asarray(points)))
    r, j_cam, j_pt, cols = tba.residuals_and_jacobians(tp, torch.as_tensor(theta), torch.as_tensor(points))
    assert j_cam.shape == (k, 2, 12) and j_pt.shape == (k, 2, 3)
    np.testing.assert_array_equal(cols.numpy(), jcols)
    assert rel(r, jr) < 1e-10
    assert rel(j_cam, jjc) < 1e-10
    assert rel(j_pt, jjp) < 1e-10
    plain = tba.residuals(tp, torch.as_tensor(theta), torch.as_tensor(points))
    assert torch.equal(plain, r)
    np.testing.assert_allclose(tba.residual_norms(tp, torch.as_tensor(theta), torch.as_tensor(points)),
                               jba.residual_norms(jp, jnp.asarray(theta), jnp.asarray(points)), rtol=1e-10)


@pytest.mark.parametrize("robust", [True, False])
def test_lm_step_with_baseline_retraction(mixed, traces, robust):
    jrig, trig = mixed
    points = traces[-1]
    jp, tp = problems(mixed, traces)
    opts = dict(lock_positions=False)
    free = jcal._free_mask(jp, jcal.CalibrationOptions(**opts), 1, 0)
    theta = jba.pack_theta(jp, jrig)
    jt, jpts, jcost = jba.lm_step(jp, jnp.asarray(theta), jnp.asarray(points), 1e-3, jnp.asarray(free),
                                  robust=robust)
    tt, tpts, tcost = tba.lm_step(tp, torch.as_tensor(theta), torch.as_tensor(points), 1e-3,
                                  torch.as_tensor(free), robust=robust)
    assert rel(tt, jt) < 1e-10 and rel(tpts, jpts) < 1e-10
    assert float(tcost) == pytest.approx(float(jcost), rel=1e-10)
    assert not np.allclose(tt.numpy(), theta)  # the step moved
    lock = (0, 1, 0.2)
    np.testing.assert_allclose(tba._retract_baseline(tp, tt, *lock).numpy(),
                               np.asarray(jba._retract_baseline(jp, jt, *lock)), rtol=1e-10, atol=1e-13)
    for got, want in ((tba.total_cost(tp, tt, tpts, robust), jba.total_cost(jp, jt, jpts, robust)),):
        assert float(got) == pytest.approx(float(want), rel=1e-9)


def test_solve_lm(mixed, traces):
    jrig, trig = mixed
    points = traces[-1]
    perturbed = jcam.perturb_cameras(jrig, rot_amount=0.01, principal_amount=1.0, seed=4)
    tpert = port_rig(tcam, perturbed)
    _, _, oc, ot, op, _, _ = traces
    jp, tp = jba.make_problem(perturbed, oc, ot, op), tba.make_problem(tpert, oc, ot, op)
    free = jcal._free_mask(jp, jcal.CalibrationOptions(), 1, 0)
    jt, jpts, jcost = jba.solve_lm(jp, jba.pack_theta(jp, perturbed), points, free, max_iterations=10)
    tt, tpts, tcost = tba.solve_lm(tp, tba.pack_theta(tp, tpert), points, free, max_iterations=10)
    assert tcost == pytest.approx(jcost, rel=1e-7)
    np.testing.assert_allclose(tt.numpy(), jt, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(tpts.numpy(), jpts, rtol=1e-7, atol=1e-9)
    assert tcost < float(tba.total_cost(tp, tba.pack_theta(tp, tpert), torch.as_tensor(points)))


# ---------------------------------------------------------------------------
# triangulation and trace bookkeeping
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("force_in_front", [True, False])
def test_triangulate(mixed, traces, force_in_front):
    jrig, trig = mixed
    _, _, oc, ot, op, nt, _ = traces
    want = jcal.triangulate_traces(jrig, oc, ot, op, nt, force_in_front=force_in_front)
    got = tcal.triangulate_traces(trig, oc, ot, op, nt, force_in_front=force_in_front)
    assert got.shape == (nt, 3) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-11)
    # one trace behind camera 0: the force_in_front branch moves it to the ray average at infinity
    behind = np.asarray([[0.0, 0.0, 3.0]]) @ np.asarray(jrig.camera(0).rotation)
    obs_cam = np.asarray([[0, 1]])
    obs_pix = np.stack([np.asarray(jcam.pixel(jrig.camera(i), behind[0])) for i in range(2)])[None]
    valid = np.ones((1, 2), bool)
    kw = dict(force_in_front=force_in_front)
    np.testing.assert_allclose(
        tba.triangulate(trig.cameras, obs_cam, obs_pix, valid, **kw).numpy(),
        jba.triangulate(np_cams(jrig), obs_cam, obs_pix, valid, **kw), rtol=1e-9, atol=1e-9)


def test_generate_artificial_points(mixed, traces):
    jrig, trig = mixed
    want_f, want_o = traces[:2]
    got_f, got_o = tcal.generate_artificial_points(trig, count=200, min_dist=1.0, error_stddev=0.3, seed=3)
    assert list(got_f) == list(want_f)
    for k in want_f:
        np.testing.assert_allclose(got_f[k], want_f[k], rtol=0, atol=1e-9)
    assert got_o == want_o


@pytest.mark.parametrize("keep_invalid", [False, True])
def test_assemble_traces(mixed, traces, keep_invalid):
    jrig, trig = mixed
    feats, overlaps = traces[:2]
    # an extra match that joins two features of camera 0 into one trace
    overlaps = overlaps + [(overlaps[0][0], overlaps[0][1], [(0, overlaps[0][2][1][1])])]
    want = jcal.assemble_traces(feats, overlaps, jrig, keep_invalid=keep_invalid)
    got = tcal.assemble_traces(feats, overlaps, trig, keep_invalid=keep_invalid)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]


def test_remove_outlier_observations(mixed, traces):
    jrig, trig = mixed
    _, _, oc, ot, op, _, points = traces
    op = op.copy()
    op[::17] += 25.0  # outliers
    points = points.copy()
    points[3] = np.nan  # a failed triangulation
    want = jcal.remove_outlier_observations(jrig, oc, ot, op, points, 5.0)
    got = tcal.remove_outlier_observations(trig, oc, ot, op, points, 5.0)
    assert 0 < (~want).sum() < len(want)
    np.testing.assert_array_equal(got, want)


def test_load_matches_json(tmp_path, mixed, traces):
    import json

    jrig, trig = mixed
    feats, overlaps = traces[:2]
    obj = {
        "images": {f"video/{cid}/000000.png": [{"x": float(x), "y": float(y)} for x, y in f]
                   for cid, f in feats.items()},
        "all_matches": [{"image1": f"video/{i0}/000000.png", "image2": f"video/{i1}/000000.png",
                         "matches": [{"idx1": a, "idx2": b, "score": 0.7 + 0.01 * (a % 10)} for a, b in pairs]}
                        for i0, i1, pairs in overlaps],
    }
    obj["images"]["video/other/000000.png"] = []
    path = str(tmp_path / "matches.json")
    with open(path, "w") as f:
        json.dump(obj, f)
    jf, jo = jcal.load_matches_json(path, jrig)
    tf, to = tcal.load_matches_json(path, trig)
    assert list(tf) == list(jf) and to == jo
    for k in jf:
        np.testing.assert_array_equal(tf[k], jf[k])


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

def test_geometric_calibration_end_to_end():
    """The rotation-perturbation case of tests/test_calibration.py (6 FTHETA
    cameras at 640x480, 800 artificial points, rotations perturbed by 0.01,
    3 passes) on the turned rig: the solved parameters and the medians agree
    to 1e-7 (measured 1e-13). test_torch_calib_cli.py solves the mixed rig
    end to end through the CLIs."""
    rig = turned(jsyn.make_test_rig(num_cameras=6, resolution=(640, 480), ring_radius=0.2, type_name="FTHETA"))
    features, overlaps = jcal.generate_artificial_points(rig, count=800, min_dist=1.0, error_stddev=0.0, seed=3)
    perturbed = jcam.perturb_cameras(rig, rot_amount=0.01, seed=4)
    opts = dict(pass_count=3, robust=True)
    want, want_median = jcal.geometric_calibration(perturbed, features, overlaps, jcal.CalibrationOptions(**opts))
    timings = {}
    got, median = tcal.geometric_calibration(port_rig(tcam, perturbed), features, overlaps,
                                             tcal.CalibrationOptions(**opts), timings=timings)
    assert median == pytest.approx(want_median, rel=1e-7, abs=1e-10)
    assert_rigs_close(got, want, rtol=1e-7, atol=1e-9)
    assert len(timings["pass_medians"]) == 3 and timings["pass_medians"][-1] == median
    assert set(timings) == {"assemble", "triangulate", "lm", "pass_medians"}
    report = tcal.rig_rmse_report(got, port_rig(tcam, rig))
    want_report = jcal.rig_rmse_report(want, rig)
    for k in want_report:
        assert report[k] == pytest.approx(want_report[k], rel=1e-6, abs=1e-9), k


def test_geometric_calibration_drops_failed_triangulations(monkeypatch, caplog):
    """A trace whose triangulation fails (NaN) is dropped before the bundle
    adjustment: the JAX package passes it on, every LM step is then
    non-finite and the median NaN."""
    import logging

    rig = turned(jsyn.make_test_rig(num_cameras=4, resolution=(320, 240), ring_radius=0.2, type_name="FTHETA"))
    features, overlaps = jcal.generate_artificial_points(rig, count=150, min_dist=1.0, error_stddev=0.3, seed=1)
    triangulate = tcal.triangulate_traces

    def failing_first_trace(*a, **k):
        points = triangulate(*a, **k).clone()
        points[0] = float("nan")
        return points

    monkeypatch.setattr(tcal, "triangulate_traces", failing_first_trace)
    with caplog.at_level(logging.INFO, logger="calibration"):
        _, median = tcal.geometric_calibration(port_rig(tcam, rig), features, overlaps,
                                               tcal.CalibrationOptions(pass_count=2))
    assert np.isfinite(median) and median < 0.8
    dropped = [r.getMessage() for r in caplog.records if "triangulation failed" in r.getMessage()]
    assert dropped == [f"pass {i}: dropped 1 traces whose triangulation failed" for i in range(2)]


def test_geometric_calibration_turns_camera_zero_of_an_unrotated_rig():
    """On the unrotated rig camera 0's rotvec is 0: the port's solve turns it
    (its rotation is free), the JAX package's leaves it exactly as it was."""
    rig = jsyn.make_test_rig(num_cameras=4, resolution=(320, 240), ring_radius=0.2, type_name="FTHETA")
    features, overlaps = jcal.generate_artificial_points(rig, count=150, min_dist=1.0, error_stddev=0.3, seed=1)
    got, _ = tcal.geometric_calibration(port_rig(tcam, rig), features, overlaps,
                                        tcal.CalibrationOptions(pass_count=1))
    assert not np.array_equal(np_cams(got).rotation[0], np.eye(3))


# ---------------------------------------------------------------------------
# rig tools
# ---------------------------------------------------------------------------


def test_umeyama():
    rng = np.random.RandomState(5)
    src = rng.randn(12, 3)
    r = np.asarray(jba.rodrigues(jnp.asarray([0.2, 0.7, -0.4])))
    dst = 1.3 * src @ r.T + np.asarray([1.0, -2.0, 0.5]) + 1e-3 * rng.randn(12, 3)
    for with_scale in (True, False):
        for g, w in zip(trt.umeyama(src, dst, with_scale), jrt.umeyama(src, dst, with_scale)):
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("locks", [(False, False, False), (True, False, False), (False, True, True)])
def test_align_and_compare_rigs(mixed, caplog, locks):
    import logging

    jrig, trig = mixed
    r = np.asarray(jba.rodrigues(jnp.asarray([0.3, -0.2, 0.5])))
    jmoved = jrt.transform_rig(jrig, r, [1.0, -2.0, 3.0], 1.7)
    tmoved = trt.transform_rig(trig, r, [1.0, -2.0, 3.0], 1.7)
    assert_rigs_close(tmoved, jmoved, rtol=1e-13, atol=1e-13)
    want = jrt.align_rig(jmoved, jrig, *locks)
    got = trt.align_rig(tmoved, trig, *locks)
    assert_rigs_close(got, want, rtol=1e-10, atol=1e-10)
    with caplog.at_level(logging.INFO, logger="rig"):
        want_avg = jrt.compare_rigs(want, jrig)
        jlines = [r.getMessage() for r in caplog.records]
        caplog.clear()
        got_avg = trt.compare_rigs(got, trig)
        tlines = [r.getMessage() for r in caplog.records]
    assert [line.split(":")[0] for line in tlines] == [line.split(":")[0] for line in jlines]
    for k in want_avg:
        assert got_avg[k] == pytest.approx(want_avg[k], rel=1e-6, abs=1e-9), k
    with pytest.raises(ValueError, match="3 shared cameras"):
        trt.align_rig(trig.subset([0, 1]), trig)


# ---------------------------------------------------------------------------
# debug imagery
# ---------------------------------------------------------------------------


def test_overlays_match_jax(tmp_path, mixed, traces):
    from facebook360_dep_tpu.calib import overlays as jov
    from facebook360_dep_tpu_torch.calib import overlays as tov

    jrig, trig = mixed
    feats, overlaps = traces[:2]
    i0, i1, pairs = overlaps[0]
    canvas = np.random.RandomState(3).randint(0, 255, (120, 160, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tov.render_match_overlay(canvas, canvas, feats[i0], feats[i1], pairs),
                                  jov.render_match_overlay(canvas, canvas, feats[i0], feats[i1], pairs))
    obs = feats[i0][:20]
    reproj = obs + np.random.RandomState(4).randn(20, 2)
    reproj[3] = np.nan
    np.testing.assert_array_equal(tov.render_reprojections(canvas, obs, reproj, 4.0),
                                  jov.render_reprojections(canvas, obs, reproj, 4.0))
    got = tov.save_match_overlays(str(tmp_path / "t"), 0, trig, feats, overlaps)
    want = jov.save_match_overlays(str(tmp_path / "j"), 0, jrig, feats, overlaps)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for g, w in zip(got, want):
        assert open(g, "rb").read() == open(w, "rb").read()


def test_geometric_calibration_debug_dir(tmp_path, mixed, traces):
    """--debug_dir writes the pass-0 match overlays and one reprojection
    render a camera (showMatches/showReprojections)."""
    _, trig = mixed
    feats, overlaps = traces[:2]
    debug = str(tmp_path / "debug")
    tcal.geometric_calibration(trig, feats, overlaps, tcal.CalibrationOptions(pass_count=1, debug_dir=debug))
    names = sorted(os.listdir(debug))
    assert [n for n in names if n.startswith("pass0_")] and all(f"{c}.png" in names for c in trig.ids)


def test_overlays_without_cv2_raise_naming_it(monkeypatch, tmp_path, mixed, traces):
    import sys

    from facebook360_dep_tpu_torch.calib import overlays as tov

    monkeypatch.setitem(sys.modules, "cv2", None)
    feats, overlaps = traces[:2]
    with pytest.raises(RuntimeError, match="OpenCV \\(cv2\\)"):
        tov.save_match_overlays(str(tmp_path / "d"), 0, mixed[1], feats, overlaps)
