"""K4's plain twin (facebook360_dep_tpu_torch/ops/warp_cuda.py:
warp_sample_planar_plain and the warp_sample_multi / warp_sample wrappers)
against the JAX package's exact XLA path (sampling.bilinear_sample) and
against the Pallas kernel it replaces (warp_pallas.warp_sample_planar), run
in interpret mode as tests/test_warp_pallas.py runs it. The kernel itself
runs only on a GPU: tests/test_torch_cuda.py and chip_smoke.py hold it
against this twin there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facebook360_dep_tpu.ops import sampling as jsamp
from facebook360_dep_tpu.ops import warp_pallas
from facebook360_dep_tpu_torch.ops import warp_cuda as wc

from torch_parity import f32, tt


def _sources(n, c, hs, ws, seed, nan_taps=True):
    src = f32(np.random.RandomState(seed).rand(n, c, hs, ws))
    if nan_taps:  # a NaN disparity patch per source, as derp_cli maps hold
        src[:, -1, 2:4, 3:6] = np.nan
    return src


def _coords(n, h, w, hs, ws, seed):
    """Coords spread past every edge (clamp-to-edge taps), a few non-finite,
    and one on a pixel center whose zero-weight neighbour tap is NaN."""
    rng = np.random.RandomState(seed)
    c = f32(np.stack([rng.uniform(-3, ws + 3, (n, h, w)), rng.uniform(-3, hs + 3, (n, h, w))], axis=-1))
    c[:, 0, 0] = [np.nan, 2.0]
    c[:, 0, 1] = [np.inf, 2.0]
    c[:, 1, 0] = [3.0, -np.inf]
    c[:, 1, 1] = [5.5, 1.5]  # center of finite pixel (1, 5); its zero-weight tap (2, 5) is NaN
    return c


def _jax_reference(src, coords):
    """bilinear_sample per source: (N, C, H, W) samples (NaN where coords
    are not finite or a tap is NaN)."""
    return np.stack([np.moveaxis(np.asarray(jsamp.bilinear_sample(jnp.asarray(np.moveaxis(s, 0, -1)),
                                                                   jnp.asarray(c))), -1, 0)
                     for s, c in zip(src, coords)])


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_twin_matches_xla_bilinear_sample(channels):
    """Same taps and lerp order as bilinear_sample; XLA may fuse a product,
    so samples agree to float32 ulps (1e-6 on values in [0, 1]); NaN taps
    propagate at the same positions; valid = finite coords, sampled 0 elsewhere."""
    src = _sources(3, channels, 9, 13, seed=channels)
    coords = _coords(3, 7, 11, 9, 13, seed=channels)
    want = _jax_reference(src, coords)
    got, valid = wc.warp_sample_planar_plain(tt(src), tt(coords))
    got, valid = got.numpy(), valid.numpy()
    np.testing.assert_array_equal(valid, np.isfinite(coords).all(-1))
    assert (got[~np.broadcast_to(valid[:, None], got.shape)] == 0).all()
    v = np.broadcast_to(valid[:, None], got.shape)
    assert np.array_equal(np.isnan(got[v]), np.isnan(want[v]))
    assert np.isnan(got[:, -1, 1, 1]).all() and np.isfinite(got[:, :-1, 1, 1]).all()
    np.testing.assert_allclose(got[v], want[v], atol=1e-6, equal_nan=True)


def test_wrappers_hwc_and_multi_match_xla():
    """warp_sample (HWC and 2-D images, any H, W) and warp_sample_multi on
    CPU tensors are the twin, laid out as the JAX signatures lay them out."""
    src = _sources(2, 3, 10, 12, seed=5, nan_taps=False)
    coords = _coords(2, 6, 9, 10, 12, seed=5)
    want = _jax_reference(src, coords)
    out, valid = wc.warp_sample_multi(tt(src), tt(coords))
    np.testing.assert_allclose(out.numpy(), np.nan_to_num(want), atol=1e-6)
    img = np.moveaxis(src[0], 0, -1).copy()
    out, valid = wc.warp_sample(tt(img), tt(coords[0]))
    assert out.shape == (6, 9, 3) and valid.shape == (6, 9)
    np.testing.assert_allclose(out.numpy(), np.nan_to_num(np.moveaxis(want[0], 0, -1)), atol=1e-6)
    out2d, valid2d = wc.warp_sample(tt(img[..., 0]), tt(coords[0]))
    assert out2d.shape == (6, 9, 1)
    np.testing.assert_array_equal(out2d.numpy()[..., 0], out.numpy()[..., 0])
    np.testing.assert_array_equal(valid2d.numpy(), valid.numpy())


def _quantized_smooth_warp(n, h, w, hs, ws, mag, seed):
    """In-window plane-sweep-like coords on B4's 1/256-px grid (as
    tests/test_warp_pallas.py makes them), so B4's quantization is exact."""
    grid = np.asarray(jsamp.pixel_center_grid(h, w))
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        c = grid * (np.asarray([ws / w, hs / h]) * mag) + rng.uniform(-3, 3, (1, 1, 2))
        out.append(np.round((c - 0.5) * 256.0) / 256.0 + 0.5)
    return f32(np.stack(out))


def test_twin_matches_pallas_b4_interpret():
    """B4 (warp_pallas.warp_sample_planar) on finite sources at in-window,
    1/256-quantized coords: its bf16 hi/lo MXU contraction is then exact to
    the 1e-5 of tests/test_warp_pallas.py:40, and every sample is valid."""
    src = _sources(2, 4, 48, 384, seed=7, nan_taps=False)
    coords = _quantized_smooth_warp(2, 16, 128, 48, 384, mag=0.9, seed=7)
    b4_out, b4_valid = warp_pallas.warp_sample_planar(jnp.asarray(src), jnp.asarray(coords), interpret=True)
    b4_out, b4_valid = np.asarray(b4_out), np.asarray(b4_valid)
    got, valid = wc.warp_sample_planar_plain(tt(src), tt(coords))
    assert b4_valid.min() == 1.0 and valid.all()
    np.testing.assert_allclose(got.numpy(), b4_out, atol=1e-5)


def test_wrappers_on_cpu_count_nothing_and_reset_covers_k4():
    src, coords = tt(_sources(2, 4, 9, 13, seed=2)), tt(_coords(2, 5, 6, 9, 13, seed=2))
    wc.LAUNCHES["warp_sample"] = 3
    wc.reset_launch_counts()
    a = wc.warp_sample_planar(src, coords)
    b = wc.warp_sample_planar_plain(src, coords)
    assert torch.equal(a[1], b[1]) and torch.equal(a[0].nan_to_num(7.0), b[0].nan_to_num(7.0))
    assert wc.LAUNCHES == {"project_sample": 0, "ssd_combine": 0, "cost_fused": 0, "warp_sample": 0,
                           "tile_windows": 0, "project_sample_tpu": 0, "cost_fused_tpu": 0, "joint_bilateral": 0,
                           "chamfer": 0}
