"""The TPU sampler's semantics in the port (ops/warp_cuda.py's TPU-mode
twins, ops/cost.py's quantize_src, stack_dtype and auto_window, the solver's
use_pallas_sampler contexts) against the JAX package's Pallas kernels, run
in interpret mode as tests/test_warp_pallas.py runs them.

The scenes are the four of tests/test_warp_pallas.py's packed test: the
test ring at 200x50, 256x48 (whole tiles in both axes) and 208x49 (49 rows:
the ring row below the image lies in a tile of its own), and an outward
ring at 200x50. Clipping is forced two ways: windows smaller than the
defaults (SMALL, on the scenes' true maps) and scattered random disparity
maps (default windows), the latter on the test ring: the outward ring's
sources see 0.5% of destination 0, too little for a scattered map to
overflow a default window there.

Tolerances. Where both sides project a pixel alike, its flags and, on
k/256 sources, its samples agree to the bit. The port projects as the JAX
package's XLA path and the Pallas kernel with a Cephes atan, so coordinates
differ by float32 ulps: a pixel whose coordinate sits within RAZOR px of
its window's edge may fall on either side (on the test ring the rows of
every source sit on whole pixels, so a row window cuts through whole rows
of such pixels), and a coordinate within an ulp of a 1/512-px rounding
boundary moves its sample by 1/256 px. So: flags agree on >= 99.9% of the
(source, pixel) pairs off the window edges; samples are bit-equal on >=
99.5% of the pixels both sides call valid and unclipped, and off by at most
1/256 px times the image's largest step between neighbours elsewhere.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facebook360_dep_tpu.core import camera as jcam
from facebook360_dep_tpu.depth import pipeline as jpipe
from facebook360_dep_tpu.depth import solver as js
from facebook360_dep_tpu.ops import cost as jcost
from facebook360_dep_tpu.ops import sampling as jsamp
from facebook360_dep_tpu.ops import warp_pallas as wp
from facebook360_dep_tpu.render import synthetic as jsyn
from facebook360_dep_tpu_torch.core import camera as tcam
from facebook360_dep_tpu_torch.depth import pipeline as tpipe
from facebook360_dep_tpu_torch.depth import solver as ts
from facebook360_dep_tpu_torch.ops import cost as tcost
from facebook360_dep_tpu_torch.ops import sampling as tsamp
from facebook360_dep_tpu_torch.ops import warp_cuda as wc

from torch_parity import f32, jax_f32, port_config, port_level_context, port_rig, rel_err, ring_rig, tt

SHAPES = ((200, 50), (256, 48), (208, 49), (200, 50))  # (W, H); the last is the outward ring
SMALL = (128, 16)  # (ww_max, wh_max): below the defaults 256 x 40
RAZOR = 1e-3
# The Pallas kernels run here one source a grid step (srcs_per_launch=1,
# V4_SRCS_PER_LAUNCH): the same results as four (each source is sampled on
# its own), and a third of the interpret mode's compile time.


def outward_ring(w, h, n=4):
    """tests/test_warp_pallas.py's outward-facing RECTILINEAR ring."""
    cams, ids = [], []
    for k in range(n):
        a = 2 * np.pi * k / n
        fwd = np.array([np.cos(a), np.sin(a), 0.0])
        up = np.array([0.0, 0.0, 1.0])
        rot = np.stack([np.cross(up, fwd), up, -fwd], axis=0)
        cams.append(jcam.make_camera(type_code=jcam.RECTILINEAR, position=[0.15 * fwd[0], 0.15 * fwd[1], 0.0],
                                     rotation=rot, resolution=[w, h], focal=[0.45 * w, -0.45 * w]))
        ids.append(f"cam{k}")
    return jcam.Rig(cameras=jcam.stack_cameras(cams), ids=tuple(ids), groups=("",) * n)


def _rig(case):
    w, h = SHAPES[case]
    if case == 3:
        return outward_ring(w, h)
    return jsyn.make_test_rig(num_cameras=4, resolution=(w, h), ring_radius=0.15)


def _scene(case, scatter):
    """Destination 0 of the scene: the quantized stack, packed cameras, rays,
    a disparity map (the truth, or scattered draws over depths 0.33-100 m),
    its colors and variance, and the window to sample it through."""
    w, h = SHAPES[case]
    rig = _rig(case)
    colors, gt = jsyn.render_sphere_scene(rig, (w, h), radius=5.0)
    colors = f32(colors)
    cams = jax_f32(jcam.normalize_rig(rig).cameras)
    cam0 = jax.tree.map(lambda a: a[0], cams)
    if scatter:
        disp = f32(np.random.RandomState(case).uniform(0.01, 3.0, (h, w)))
    else:
        disp = f32(np.nan_to_num(gt[0], nan=1e-4))
    return dict(
        w=w, h=h, stack=f32(jcost.quantize_src(jnp.asarray(np.moveaxis(colors, -1, 1)))),
        params=f32(wp.pack_camera_params_traced(cams)), pos=f32(cam0.position),
        rays=f32(np.moveaxis(np.asarray(jcost.dst_ray_dirs(cam0, h, w)), -1, 0)), disp=disp,
        dst=f32(np.moveaxis(colors[0], -1, 0)), var=f32(jsamp.rgb_variance(jnp.asarray(colors[0]))),
        window=None if scatter else SMALL)


def _pallas_window(s):
    return (None, None) if s["window"] is None else s["window"]


def _port_args(s, stack=None):
    stack = s["stack"] if stack is None else stack
    return (tt(stack), tt(s["params"]), tt(s["pos"]), tt(s["disp"]), tt(s["rays"]))


def _off_edges(s, anchors, align=8):
    """(N, H, W) True where the port's coordinate lies farther than RAZOR
    from every edge of its tile's window."""
    xt, yt, _ = wc._tpu_coords(tt(s["params"]), tt(s["pos"]), tt(s["disp"]), tt(s["rays"]), (s["h"], s["w"]))
    ty = (torch.arange(s["h"]) // wc.V4_TILE_H)[:, None]
    tx = (torch.arange(s["w"]) // wc.TILE_W)[None, :]
    return _far_from_edges(s, xt, yt, anchors[:, ty, tx], align)


def _far_from_edges(s, xt, yt, org, align=8):
    ww, wh, _, _ = wc.window_dims((s["h"], s["w"]), s["window"], align)
    org = org.double()
    near = torch.zeros_like(xt, dtype=torch.bool)
    for a, edge in ((xt, org[..., 0]), (xt, org[..., 0] + ww - 1), (yt, org[..., 1]), (yt, org[..., 1] + wh - 1)):
        near |= (a.double() - edge).abs() < RAZOR
    return (~near).numpy()


def _hold_flags_and_samples(s, got, want, anchors, exact=True):
    """The contract of the module docstring; returns the clipped share."""
    (g_s, g_v, g_c), (p_s, p_v, p_c) = got, want
    g_s, g_v, g_c = (x.numpy() for x in (g_s, g_v, g_c))
    p_v, p_c = p_v > 0.5, p_c > 0.5
    off = _off_edges(s, anchors)
    for name, a, b in (("valid", g_v, p_v), ("clipped", g_c, p_c)):
        assert (a != b)[off].mean() <= 1e-3, (name, (a != b)[off].mean())
    both = g_v & p_v
    mask = np.broadcast_to(both[:, None], g_s.shape)
    step = max(np.abs(np.diff(s["stack"], axis=a)).max() for a in (2, 3))
    err = np.abs(g_s - p_s)[mask]
    if exact:
        assert (err == 0).mean() >= 0.995, (err == 0).mean()
        assert err.max() <= step / 256.0 + 1e-7, (err.max(), step)
    assert np.all(g_s[~np.broadcast_to(g_v[:, None], g_s.shape)] == 0.0)
    return p_c.mean()


@pytest.mark.parametrize("case,scatter", [(0, False), (3, False), (0, True), (1, True)])
def test_k1_tpu_twin_vs_pallas_v4(case, scatter):
    """K1's TPU twin (tile_windows + project_sample_tpu, C = 3) against
    project_sample_planar_v4 on the quantized stack (the ring regimes of
    the other shapes matter to the packed path: the K3 tests take them)."""
    s = _scene(case, scatter)
    win = _pallas_window(s)
    want = [np.asarray(a) for a in wp.project_sample_planar_v4(
        jnp.asarray(s["stack"]), jnp.asarray(s["params"]), jnp.asarray(s["pos"]), jnp.asarray(s["disp"]),
        jnp.asarray(s["rays"]), src_exact_bf16=True, ww_max=win[0], wh_max=win[1], srcs_per_launch=1)]
    rgba = wc.rgba_stack(tt(np.moveaxis(s["stack"], 1, -1)))
    args = (tt(s["params"]), tt(s["pos"]), tt(s["disp"]), tt(s["rays"]))
    anchors = wc.tile_windows(*args, (s["h"], s["w"]), s["window"])
    assert anchors.shape == (4, -(-s["h"] // 24), -(-s["w"] // 128), 2) and anchors.dtype == torch.int32
    got = wc.project_sample_tpu(rgba, *args, anchors, s["window"])
    clipped = _hold_flags_and_samples(s, got, want, anchors)
    assert clipped > 0.0, "nothing clipped"


def test_k1_tpu_planes_vs_pallas_v4():
    """K1's TPU twin on the mismatch stage's two planes (NaN-filled
    disparities with NaN holes, their finite mask), which are not
    quantized: the Pallas kernel splits each window into bf16 hi and lo
    parts and adds two contractions, so its samples differ from the
    twin's lerp by float32 roundings: 1e-6 relative."""
    s = _scene(0, False)
    rng = np.random.RandomState(5)
    disps = f32(rng.uniform(0.1, 0.3, (4, s["h"], s["w"])))
    disps[:, 10:20, 30:60] = np.nan
    planes = f32(np.stack([np.nan_to_num(disps), np.isfinite(disps)], axis=1))
    win = _pallas_window(s)
    want = [np.asarray(a) for a in wp.project_sample_planar_v4(
        jnp.asarray(planes), jnp.asarray(s["params"]), jnp.asarray(s["pos"]), jnp.asarray(s["disp"]),
        jnp.asarray(s["rays"]), ww_max=win[0], wh_max=win[1], srcs_per_launch=1)]
    args = (tt(s["params"]), tt(s["pos"]), tt(s["disp"]), tt(s["rays"]))
    anchors = wc.tile_windows(*args, (s["h"], s["w"]), s["window"])
    got = wc.project_sample_planes_tpu(tt(planes), *args, anchors, s["window"])
    assert _hold_flags_and_samples(dict(s, stack=planes), got, want, anchors, exact=False) > 0.0
    both = got[1].numpy() & (want[1] > 0.5)
    g, p = got[0].numpy()[:, 0][both], want[0][:, 0][both]
    assert (rel_err(g, p) <= 1e-6).mean() >= 0.995
    assert ((got[0][:, 1].numpy() > 0.999) != (want[0][:, 1] > 0.999))[both].mean() <= 1e-3


@pytest.mark.parametrize("case,scatter", [(0, False), (1, False), (2, False), (3, False), (0, True)])
def test_k3_tpu_twin_vs_pallas_packed(case, scatter):
    """K3's TPU twin against project_sample_packed + ssd_combine(true_shape):
    what the packed path lays down, the image and its ring (flags and
    rounded samples under the module docstring's contract), then the costs:
    the Pallas combine multiplies by 1/cnt where the twin divides, so they
    agree to 1e-5 relative, with FLT_MAX where a non-self source clips the pixel and no sample of
    its patch moved (a flag flipped, or a sample took the next 1/256 px)."""
    s = _scene(case, scatter)
    h, w = s["h"], s["w"]
    win = _pallas_window(s)
    packed = wp.project_sample_packed(
        jnp.asarray(s["stack"]), jnp.asarray(s["params"]), jnp.asarray(s["pos"]), jnp.asarray(s["disp"]),
        jnp.asarray(s["rays"]), src_exact_bf16=True, ww_max=win[0], wh_max=win[1], srcs_per_launch=1)
    p_cost, p_conf = map(np.asarray, wp.ssd_combine(packed, None, jnp.asarray(s["dst"]), jnp.asarray(s["var"]), 0,
                                                    min_keep=1, true_shape=(h, w)))
    args = (tt(s["params"]), tt(s["pos"]), tt(s["disp"]), tt(s["rays"]))
    anchors = wc.tile_windows(*args, (h, w), s["window"], reflect=True)
    rgba = wc.rgba_stack(tt(np.moveaxis(s["stack"], 1, -1)))
    cost, conf = (x.numpy() for x in wc.cost_fused_tpu(rgba, *args, tt(s["dst"]), tt(s["var"]), 0, anchors,
                                                       s["window"]))

    # the image and its ring as the packed path wrote them (warp_pallas.py:607-636)
    buf = np.asarray(packed)[:, :, 7:9 + h, 127:129 + w].astype(np.int64)
    p_valid, p_clip = buf[:, 0] >= 0, buf[:, 0] == -2
    gb = buf[:, 1] & 0xFFFFFFFF
    p_s = np.stack([buf[:, 0] / 2.0 ** 24, (gb >> 16) / 65536.0, (gb & 0xFFFF) / 65536.0], axis=1)
    g_s, g_v, g_c = (x.numpy() for x in wc.ring_samples_tpu_plain(tt(s["stack"]), *args, anchors, s["window"]))
    xt, yt, _ = wc._tpu_coords(*args, (h, w))
    (ry, ty), (rx, tx) = wc._ring(h, wc.V4_TILE_H), wc._ring(w, wc.TILE_W)
    off = _far_from_edges(s, xt[:, ry[:, None], rx[None, :]], yt[:, ry[:, None], rx[None, :]],
                          anchors[:, ty[:, None], tx[None, :]])
    for name, a, b in (("valid", g_v, p_valid), ("clipped", g_c, p_clip)):
        assert (a != b)[off].mean() <= 1e-3, (name, (a != b)[off].mean())
    both = np.broadcast_to((g_v & p_valid)[:, None], g_s.shape)
    assert (g_s == p_s)[both].mean() >= 0.995
    assert p_clip[1:].any(), "nothing clipped"

    fin, p_fin = cost < 1e30, p_cost < 1e30
    moved = (g_v != p_valid) | (g_c != p_clip) | ((g_s != p_s).any(1) & g_v & p_valid)  # ulps of the projections
    flipped = moved[1:].any(0).astype(np.float32)
    patch = (np.lib.stride_tricks.sliding_window_view(flipped, (3, 3)).sum(axis=(2, 3)) == 0)
    assert patch.mean() > 0.9
    assert np.array_equal(fin[patch], p_fin[patch])
    assert (~p_fin & p_clip[1:, 1:-1, 1:-1].any(0)).any()  # the guard fired
    both = fin & p_fin & patch
    assert (rel_err(cost[both], p_cost[both]) <= 1e-5).mean() >= 0.999
    assert np.array_equal(conf[patch], p_conf[patch])


def _reflect1(x, tile, axis):
    """warp_pallas._reflect1_grid_pad along one axis."""
    return x.index_select(axis, wc.tile_grid(x.shape[axis], tile, reflect=True))


@pytest.mark.parametrize("w,h", [(256, 48), (200, 50), (256, 50), (200, 48), (208, 49)])
def test_k3_tpu_ring_is_the_packed_writers(w, h):
    """The four ring regimes (whole tiles or not, in each axis) without JAX:
    an independent emulation of project_sample_packed's writes
    (warp_pallas.py:571-753) -- the bulk of every tile of the reflect-padded
    grid at its place, then the top and left ring slivers from row and
    column 1, and where the image is whole tiles the bottom and right
    slivers from row h - 2 and column w - 2 and the corners -- fills the
    ring, and the SSD combine over it equals K3's TPU twin bit for bit."""
    rig = jsyn.make_test_rig(num_cameras=4, resolution=(w, h), ring_radius=0.15)
    colors, gt = jsyn.render_sphere_scene(rig, (w, h), radius=5.0)
    trig = port_rig(tcam, jcam.normalize_rig(rig))
    cams = trig.cameras.to(dtype=torch.float32)
    params = wc.pack_camera_params(cams)
    pos, rays = cams.position[0], tcost.dst_ray_dirs(cams.index(0), h, w).permute(2, 0, 1).contiguous()
    disp = tt(np.random.RandomState(w + h).uniform(0.01, 3.0, (h, w)))
    stack = tcost.quantize_src(tt(colors).permute(0, 3, 1, 2))
    dst, var = tt(colors[0]).permute(2, 0, 1), tsamp.rgb_variance(tt(colors[0]))
    anchors = wc.tile_windows(params, pos, disp, rays, (h, w), SMALL, reflect=True)
    want = wc.cost_fused_tpu(wc.rgba_stack(stack.permute(0, 2, 3, 1)), params, pos, disp, rays, dst, var, 0,
                             anchors, SMALL)

    xt, yt, ok = wc._tpu_coords(params, pos, disp, rays, (h, w))
    xt, yt, ok = (_reflect1(_reflect1(a, wc.V4_TILE_H, 1), wc.TILE_W, 2) for a in (xt, yt, ok))
    grid_anchors = wc._anchors(xt, yt, ok, (h, w), SMALL, 8, reflect=False)  # the padded grid is whole tiles
    assert torch.equal(grid_anchors, anchors)
    hp, wq = xt.shape[1:]
    org = grid_anchors[:, torch.arange(hp)[:, None] // wc.V4_TILE_H, torch.arange(wq)[None, :] // wc.TILE_W]
    ww, wh, _, _ = wc.window_dims((h, w), SMALL)
    samples, valid, clipped = wc._tpu_sample(stack, xt, yt, ok, org[..., 0], org[..., 1], ww, wh)
    samples = wc.packed_round(samples)
    planes = torch.cat([samples, valid[:, None].float(), clipped[:, None].float()], dim=1)  # (N, 5, hp, wq)
    ring = torch.full((4, 5, h + 2, w + 2), float("nan"))
    rows, cols = min(hp, h + 1), min(wq, w + 1)
    ring[:, :, 1:1 + rows, 1:1 + cols] = planes[:, :, :rows, :cols]  # bulk
    ring[:, :, 0, 1:1 + cols] = planes[:, :, 1, :cols]  # top ring <- row 1
    ring[:, :, 1:1 + rows, 0] = planes[:, :, :rows, 1]  # left ring <- column 1
    ring[:, :, 0, 0] = planes[:, :, 1, 1]
    if w % wc.TILE_W == 0:
        ring[:, :, 1:1 + rows, w + 1] = planes[:, :, :rows, w - 2]
        ring[:, :, 0, w + 1] = planes[:, :, 1, w - 2]
    if h % wc.V4_TILE_H == 0:
        ring[:, :, h + 1, 1:1 + cols] = planes[:, :, h - 2, :cols]
        ring[:, :, h + 1, 0] = planes[:, :, h - 2, 1]
    if h % wc.V4_TILE_H == 0 and w % wc.TILE_W == 0:
        ring[:, :, h + 1, w + 1] = planes[:, :, h - 2, w - 2]
    assert not ring.isnan().any()
    dst_ring = torch.nn.functional.pad(dst, (1, 1, 1, 1), mode="reflect")
    biased, unbiased, v = tcost.ssd_ringed(dst_ring, ring[:, :3], ring[:, 3] > 0)
    not_self = torch.arange(4) != 0
    cost, conf = tcost.combine_top2(biased, unbiased, v & not_self[:, None, None], var)
    cost = torch.where((ring[1:, 4, 1:-1, 1:-1] > 0).any(0), tcost.FLT_MAX, cost)
    assert torch.equal(cost, want[0]) and torch.equal(conf, want[1])
    assert (want[0] == tcost.FLT_MAX).any() and (want[0] < tcost.FLT_MAX).any()


def test_quantize_src_and_stack_dtype(monkeypatch):
    """quantize_src equals the JAX function bit for bit on [0, 1]. Above 1
    (and below 0) the port clamps first: the rule of ROADMAP's "reference
    quirks not to copy" (the JAX function leaves 1.3 at 333/256)."""
    rng = np.random.RandomState(0)
    x = f32(np.concatenate([rng.rand(4000), [0.0, 1.0, 0.5 / 256, 1.5 / 256, 255.5 / 256, 1 - 1e-7]]))
    want = np.asarray(jcost.quantize_src(jnp.asarray(x)))
    got = tcost.quantize_src(tt(x)).numpy()
    assert got.dtype == np.float32 and np.array_equal(got.view(np.int32), want.view(np.int32))
    assert tcost.quantize_src(tt(f32([1.3, -0.2]))).tolist() == [1.0, 0.0]
    assert float(jcost.quantize_src(jnp.float32(1.3))) == 333 / 256
    bf = tcost.quantize_src(tt(x), dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16 and torch.equal(bf.float(), tt(got))
    assert tcost.stack_dtype() == torch.float32 and jcost.stack_dtype() == jnp.float32
    for mod in (tcost, jcost):
        monkeypatch.setattr(mod, "SRC_STACK_BF16", True)
    assert tcost.stack_dtype() == torch.bfloat16 and jcost.stack_dtype() == jnp.bfloat16
    assert tcost.window_align() == 16
    assert wc.window_dims((49, 208), None, 16) == (256, 48, 64, 256)
    for mod in (tcost, jcost):
        monkeypatch.setattr(mod, "SRC_QUANT_EXACT", False)
    assert tcost.stack_dtype() == torch.float32 and jcost.stack_dtype() == jnp.float32


def _ftheta_ring():
    """The production FTHETA shape (outward fisheye ring with a top camera,
    the production distortion) with 4 side cameras at 320x206."""
    return jsyn.make_ftheta_ring_rig(4, 0.33, (320, 206), distortion=jsyn.PRODUCTION_FTHETA_DISTORTION)


@pytest.mark.parametrize("rig_of", [lambda: _rig(0), lambda: _rig(3), _ftheta_ring], ids=["sphere", "outward", "ftheta"])
def test_auto_window_vs_jax(rig_of, caplog):
    """Window sizes and the warning text equal the JAX function's (float32
    cameras on both sides); the FTHETA ring wants more rows than the cap,
    and both warn."""
    raw = rig_of()
    w, h = (int(v) for v in np.asarray(raw.cameras.resolution)[0])
    rig = jcam.normalize_rig(raw)
    cams = jax_f32(rig.cameras)
    tcams = tcam.camera_from_numpy(cams, dtype=torch.float32)
    with caplog.at_level(logging.WARNING):
        want = jcost.auto_window(cams, cams, (h, w), min_depth=1.0, max_depth=100.0)
        got = tcost.auto_window(tcams, tcams, (h, w), min_depth=1.0, max_depth=100.0)
    assert got == want
    msgs = {r.name: r.getMessage() for r in caplog.records}
    assert msgs.get("facebook360_dep_tpu_torch.ops.cost") == msgs.get("facebook360_dep_tpu.ops.cost"), msgs
    if rig_of is _ftheta_ring:
        assert got == (256, 88) and "exceeds cap 256x88" in msgs["facebook360_dep_tpu_torch.ops.cost"]


@pytest.fixture(scope="module")
def tpu_contexts():
    """A JAX level context with the Pallas sampler and the port's with the
    TPU sampler's stack, of the same rig and colors (200x50, 4 cameras)."""
    rig = jcam.normalize_rig(_rig(0))
    w, h = SHAPES[0]
    colors, gt = jsyn.render_sphere_scene(_rig(0), (w, h), radius=5.0)
    colors = f32(colors)
    trig = port_rig(tcam, rig)
    jctx = js.make_level_context(rig, rig, colors, jpipe.generate_fov_masks(rig, (h, w)), full_height=100,
                                 use_pallas_sampler=True)
    tctx = ts.make_level_context(trig, trig, tt(colors), tpipe.generate_fov_masks(trig, (h, w)), full_height=100,
                                 use_pallas_sampler=True)
    return jctx, tctx, f32(gt), trig


def test_level_context_carries_the_tpu_stack(tpu_contexts):
    """The port's stack holds the JAX context's src_imgs_t (interleaved, with
    a zero pad); cost contexts and other frames carry it; the default
    context has none."""
    jctx, tctx, _, trig = tpu_contexts
    assert torch.equal(wc.planar_view(tctx.src_tpu), tt(jctx.src_imgs_t))
    assert not tctx.src_tpu[..., 3].any() and tctx.tpu_align == 8
    assert torch.equal(tctx.src_variance, tsamp.rgb_variance(tctx.src_imgs))  # built a source at a time, the same bits
    cctx = ts.cost_context(tctx)
    assert cctx.src_tpu is tctx.src_tpu and cctx.tpu_align == 8
    frame = ts.with_images(tctx, tctx.src_imgs * 0.5)
    assert torch.equal(frame.src_tpu, wc.rgba_stack(tcost.quantize_src(tctx.src_imgs * 0.5)))
    assert ts.make_level_context(trig, trig, tctx.src_imgs, tctx.dst_fov_masks).src_tpu is None


def test_cost_for_disparity_window_vs_jax(tpu_contexts, monkeypatch):
    """cost_for_disparity(window=) on use_pallas_sampler contexts, below
    FUSED_MIN_PIXELS: K1 then K2 then the clip guard on both sides. Costs
    and the FLT_MAX pattern agree (1e-5 relative: K2's 1/cnt) at every pixel
    no sample of whose patch moved with the projections' ulps (as in
    test_k3_tpu_twin_vs_pallas_packed)."""
    monkeypatch.setattr(wp, "V4_SRCS_PER_LAUNCH", 1)
    jctx, tctx, gt, _ = tpu_contexts
    disp = f32(np.nan_to_num(gt[0], nan=1e-4))
    jcc = js._cost_ctx(jctx, 0)
    j_cost, j_conf = map(np.asarray, jcost.cost_for_disparity(jcc, jnp.asarray(disp), window=SMALL))
    cctx = ts.cost_context(ts.select_destinations(tctx, [0]))
    cost, conf = (x[0].numpy() for x in tcost.cost_for_disparity(cctx, tt(disp)[None], window=SMALL))
    # the samples both sides drew
    p_s, p_v, p_c = (np.asarray(a) for a in wp.project_sample_planar_v4(
        jcc.src_imgs_t, wp.pack_camera_params_traced(jcc.src_cams), jcc.cam_dst.position, jnp.asarray(disp),
        jnp.moveaxis(jcc.dst_rays, -1, 0), src_exact_bf16=True, ww_max=SMALL[0], wh_max=SMALL[1]))
    args = (cctx.src_params, cctx.cam_dst.position[0], tt(disp), cctx.dst_rays[0])
    g_s, g_v, g_c = (x.numpy() for x in wc.project_sample_tpu(
        cctx.src_tpu, *args, wc.tile_windows(*args, tuple(gt.shape[1:]), SMALL), SMALL))
    moved = (g_v != (p_v > 0.5)) | (g_c != (p_c > 0.5)) | ((g_s != p_s).any(1) & g_v)
    patch = np.pad(moved[1:].any(0), 1, mode="reflect").astype(np.float32)
    patch = np.lib.stride_tricks.sliding_window_view(patch, (3, 3)).sum(axis=(2, 3)) == 0
    assert patch.mean() > 0.9
    fin, j_fin = cost < 1e30, j_cost < 1e30
    assert (~j_fin).mean() > 0.1 and fin.mean() > 0.1  # clipping made some costs unevaluable
    assert np.array_equal(fin[patch], j_fin[patch])
    both = fin & j_fin & patch
    assert (rel_err(cost[both], j_cost[both]) <= 1e-5).mean() >= 0.999
    assert np.array_equal(conf[patch], j_conf[patch])


def _threefry_uniforms(key, d, p, h, w):
    """The JAX random_proposals draws (solver.py:232, 243, 252) as (D, P, H, W)."""
    return f32([[np.asarray(jax.random.uniform(kk, (h, w), jnp.float32)) for kk in jax.random.split(k, p)]
                for k in jax.random.split(key, d)])


def test_process_level_tpu_mode_vs_jax(tpu_contexts, monkeypatch):
    """One level of four cameras on use_pallas_sampler contexts with a
    small window and the JAX draws injected: the share of pixels that agree
    (ties and flag flips aside, ROADMAP "Known differences"), and both as
    close to the truth."""
    monkeypatch.setattr(wp, "V4_SRCS_PER_LAUNCH", 1)
    jctx, tctx, gt, _ = tpu_contexts
    jcfg = js.SolverConfig(min_depth=1.0, max_depth=100.0, level=1, num_levels=3, num_random_proposals=2,
                           ping_pong_iterations=1, ww_max=SMALL[0], wh_max=SMALL[1])
    init = f32(np.nan_to_num(gt, nan=1e-4) * (1.0 + 0.1 * np.random.RandomState(1).randn(*gt.shape)))
    key = jax.random.PRNGKey(3)
    j = jax.tree.map(np.asarray, js.process_level(jctx, jcfg, init_disparity=jnp.asarray(init), key=key))
    carried = port_level_context(ts, tcam, jctx)  # the JAX context's own state, its stack included
    assert torch.equal(carried.src_tpu, tctx.src_tpu) and carried.tpu_align == 8
    t = {k: v.numpy() for k, v in ts.process_level(
        carried, port_config(ts, jcfg), init_disparity=tt(init),
        uniforms=tt(_threefry_uniforms(key, 4, 2, *gt.shape[1:]))).items()}
    assert np.array_equal(np.isnan(t["disparity"]), np.isnan(j["disparity"]))
    fin = np.isfinite(j["disparity"]) & np.isfinite(gt)
    agree = (rel_err(t["disparity"][fin], j["disparity"][fin]) < 1e-5).mean()
    assert agree > 0.97, agree

    def rmse(d):
        return np.sqrt(np.mean((d[fin] / gt[fin] - 1.0) ** 2))

    assert abs(rmse(t["disparity"]) - rmse(j["disparity"])) < 0.1 * rmse(j["disparity"]), (
        rmse(t["disparity"]), rmse(j["disparity"]))
    assert rmse(t["disparity"]) < rmse(init)


def test_solver_threads_the_window(tpu_contexts, monkeypatch):
    """SolverConfig.ww_max/wh_max reach every sampling stage (solver.py:198,
    224, 234, 305, 376-379): the brute force, the proposals, ping-pong and
    the mismatch stage's K1 in TPU mode (its anchors)."""
    _, tctx, gt, _ = tpu_contexts
    costs, anchors, sweeps = [], [], []
    real_cost, real_tw, real_bf = tcost.cost_for_disparity, wc.tile_windows, tcost.brute_force_disparity

    def cost(ctx, disparity, window=None):
        costs.append(window)
        return real_cost(ctx, disparity, window)

    def tw(*a, **k):
        anchors.append(a[5] if len(a) > 5 else k.get("window"))
        return real_tw(*a, **k)

    def bf(*a, **k):
        sweeps.append(k["window"])
        return real_bf(*a, **dict(k, num_depths=3))

    monkeypatch.setattr(tcost, "cost_for_disparity", cost)
    monkeypatch.setattr(wc, "tile_windows", tw)
    monkeypatch.setattr(tcost, "brute_force_disparity", bf)
    kw = dict(min_depth=1.0, max_depth=100.0, num_levels=3, num_random_proposals=1, mismatches_start_level=1,
              ww_max=SMALL[0], wh_max=SMALL[1])
    ts.process_level(tctx, ts.SolverConfig(level=2, **kw))
    assert sweeps == [SMALL] and costs == [SMALL] * 3 and anchors == [SMALL] * 3
    costs.clear(), anchors.clear()
    ts.process_level(tctx, ts.SolverConfig(level=1, **kw), init_disparity=tt(np.nan_to_num(gt, nan=1e-4)))
    assert costs == [SMALL] * (1 + 1 + 8)  # the start map, one proposal, the star's 8 candidates
    assert anchors == [SMALL] * (10 + 1)  # one a cost evaluation, one for the mismatch stage
