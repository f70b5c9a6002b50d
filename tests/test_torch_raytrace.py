"""The port's raytracer (render/raytrace.py) against the JAX package's, on
the same seeded numpy inputs: the BVH arrays, brute force and the BVH
traversal, Perlin noise, and the occluder room rendered into a rig and into
an equirect.

Tolerances: ``build_bvh`` arrays equal; hit distances within 2e-5 relative
(float32 Moller-Trumbore, whose differences cancel for near hits; XLA may
order the products otherwise), the hit
triangle equal on all but 0.5% of rays (a ray through a shared edge may
hit either triangle) and the set of rays that hit equal; inside the port
the BVH equals brute force exactly (ties go to the lowest triangle index
on both paths). Perlin noise equal on the integer lattice and within 1e-6
elsewhere; renders within 1e-5 in color and 1e-6 relative in disparity.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from facebook360_dep_tpu.render import raytrace as jrt
from facebook360_dep_tpu.render import synthetic as jsyn
from facebook360_dep_tpu_torch.render import raytrace as trt
from facebook360_dep_tpu_torch.render import synthetic as tsyn

import torch_parity  # noqa: F401  (two torch threads per worker)

T_RTOL = 2e-5
TRI_DIFF_FRAC = 0.005


def _soup(n=300, seed=0):
    rng = np.random.RandomState(seed)
    verts = (rng.uniform(-5, 5, (n, 1, 3)) + rng.uniform(-0.6, 0.6, (n, 3, 3))).astype(np.float32)
    colors = rng.rand(n, 3).astype(np.float32)
    return (jrt.TriangleMesh(jnp.asarray(verts), jnp.asarray(colors)),
            trt.TriangleMesh(torch.from_numpy(verts), torch.from_numpy(colors)), verts)


def _rays(n=3000, seed=1):
    rng = np.random.RandomState(seed)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (0.3 * rng.randn(n, 3)).astype(np.float32)
    return o, d


def test_build_bvh_arrays_equal_jax():
    _, _, verts = _soup(n=257)
    want = jrt.build_bvh(verts)
    got = trt.build_bvh(verts)
    for field in want._fields:
        assert np.array_equal(np.asarray(getattr(want, field)), getattr(got, field).numpy()), field
    assert int(got.escape[0]) == got.escape.shape[0]


@pytest.mark.parametrize("path", ["brute", "bvh"])
def test_intersection_matches_jax(path):
    jmesh, tmesh, verts = _soup()
    o, d = _rays()
    if path == "brute":
        tj, ij = jrt.intersect_brute(jmesh, jnp.asarray(o), jnp.asarray(d))
        tt, it = trt.intersect_brute(tmesh, torch.from_numpy(o), torch.from_numpy(d))
    else:
        tj, ij = jrt.intersect_bvh(jrt.build_bvh(verts), jmesh, jnp.asarray(o), jnp.asarray(d))
        tt, it = trt.intersect_bvh(trt.build_bvh(verts), tmesh, torch.from_numpy(o), torch.from_numpy(d))
    tj, ij, tt, it = np.asarray(tj), np.asarray(ij), tt.numpy(), it.numpy()
    hit = np.isfinite(tj)
    assert np.array_equal(hit, np.isfinite(tt))
    assert 0.05 < hit.mean() < 0.95  # both hits and misses
    np.testing.assert_allclose(tt[hit], tj[hit], rtol=T_RTOL)
    assert (it != ij).mean() <= TRI_DIFF_FRAC
    assert (it[~hit] == -1).all()


def test_port_bvh_equals_its_brute_force():
    _, tmesh, verts = _soup(n=400, seed=3)
    o, d = _rays(n=4000, seed=4)
    bvh = trt.build_bvh(verts)
    tb, ib = trt.intersect_bvh(bvh, tmesh, torch.from_numpy(o), torch.from_numpy(d), chunk_rays=1500)
    tr, ir = trt.intersect_brute(tmesh, torch.from_numpy(o), torch.from_numpy(d), chunk_elements=50000)
    assert torch.isfinite(tb).any()
    assert torch.equal(tb, tr) and torch.equal(ib, ir)


def test_port_bvh_equals_brute_force_on_shared_edges():
    """Rays aimed at the room's triangle edges and corners, where two
    triangles tie: both paths name the lower index."""
    tmesh = trt.box_room_with_occluders(num_occluders=4)
    v = tmesh.vertices
    targets = torch.cat([0.5 * (v[:, 0] + v[:, 2]), v[:, 1], (v[:, 0] + v[:, 1] + v[:, 2]) / 3])
    d = targets / torch.linalg.norm(targets, dim=-1, keepdim=True)
    o = torch.zeros_like(d)
    tb, ib = trt.intersect_bvh(trt.build_bvh(v), tmesh, o, d)
    tr, ir = trt.intersect_brute(tmesh, o, d)
    assert torch.isfinite(tr).all()
    assert torch.equal(tb, tr) and torch.equal(ib, ir)


def test_perlin_matches_jax():
    rng = np.random.RandomState(3)
    pts = rng.uniform(-20, 20, (20000, 3)).astype(np.float32)
    np.testing.assert_allclose(trt.perlin(torch.from_numpy(pts)).numpy(), np.asarray(jrt.perlin(jnp.asarray(pts))),
                               rtol=0, atol=1e-6)
    lattice = np.mgrid[-4:4, -4:4, -4:4].reshape(3, -1).T.astype(np.float32)
    want = np.asarray(jrt.perlin(jnp.asarray(lattice)))
    got = trt.perlin(torch.from_numpy(lattice)).numpy()
    assert np.array_equal(got, want) and not np.abs(got).any()
    np.testing.assert_allclose(trt.perlin_fbm(torch.from_numpy(pts), octaves=5).numpy(),
                               np.asarray(jrt.perlin_fbm(jnp.asarray(pts), octaves=5)), rtol=0, atol=1e-6)


def test_occluder_room_equals_jax():
    jmesh = jrt.box_room_with_occluders(num_occluders=4, seed=12)
    tmesh = trt.box_room_with_occluders(num_occluders=4, seed=12)
    assert np.array_equal(np.asarray(jmesh.vertices), tmesh.vertices.numpy())
    assert np.array_equal(np.asarray(jmesh.colors), tmesh.colors.numpy())
    assert tmesh.vertices.shape == (60, 3, 3)


@pytest.mark.parametrize("force_bvh", [False, True])
def test_render_mesh_scene_matches_jax(monkeypatch, force_bvh):
    """4 cameras at 64x48 in the occluder room: 60 triangles take brute
    force; the forced BVH gives the port's brute-force render exactly."""
    jrig = jsyn.make_test_rig(4, (64, 48), ring_radius=0.2)
    trig = tsyn.make_test_rig(4, (64, 48), ring_radius=0.2)
    jmesh = jrt.box_room_with_occluders(num_occluders=4)
    tmesh = trt.box_room_with_occluders(num_occluders=4)
    cj, dj = jrt.render_mesh_scene(jrig, (64, 48), jmesh, row_chunk=16)
    brute = trt.render_mesh_scene(trig, (64, 48), tmesh, row_chunk=16)
    if force_bvh:
        monkeypatch.setattr(trt, "BRUTE_FORCE_MAX_TRIANGLES", 0)
        got = trt.render_mesh_scene(trig, (64, 48), tmesh, row_chunk=16)
        assert torch.equal(got[0], brute[0]) and torch.equal(got[1], brute[1])
    ct, dt = brute
    assert ct.shape == (4, 48, 64, 3) and torch.isfinite(dt).all()
    np.testing.assert_allclose(ct.numpy(), cj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-6)


def test_ground_truth_equirect_mesh_matches_jax():
    jmesh = jrt.box_room_with_occluders(num_occluders=4)
    tmesh = trt.box_room_with_occluders(num_occluders=4)
    cj, dj = jrt.ground_truth_equirect_mesh(jmesh, 128, 64)
    ct, dt = trt.ground_truth_equirect_mesh(tmesh, 128, 64)
    assert ct.shape == (64, 128, 3) and torch.isfinite(dt).all()
    np.testing.assert_allclose(ct.numpy(), cj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-6)
    # the occluders stand in front of the walls: nearer than the nearest
    # wall (the floor and ceiling, 3 m from the center)
    assert float(dt.max()) > 1.0 / 3.0 + 0.05


def test_closed_room_is_watertight():
    """8 cameras at 160x120 in the occluder room (the simulator's seed 7):
    rays along a wall's shared diagonal escape the JAX package's room (NaN
    truth, ROADMAP queue C); the port's barycentric slack catches them, and
    elsewhere its colors stay within 1e-5 of the JAX render."""
    jrig = jsyn.make_test_rig(8, (160, 120), ring_radius=0.25)
    trig = tsyn.make_test_rig(8, (160, 120), ring_radius=0.25)
    cj, dj = jrt.render_mesh_scene(jrig, (160, 120), jrt.box_room_with_occluders(seed=7), row_chunk=60)
    ct, dt = trt.render_mesh_scene(trig, (160, 120), trt.box_room_with_occluders(seed=7))
    assert np.isnan(dj).sum() > 0
    assert torch.isfinite(dt).all()
    ok = np.isfinite(dj)
    np.testing.assert_allclose(dt.numpy()[ok], dj[ok], rtol=1e-6)
    assert (np.abs(ct.numpy() - cj).max(axis=-1)[ok] > 1e-5).mean() < 1e-4
