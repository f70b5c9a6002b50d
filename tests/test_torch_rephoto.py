"""The port's rephotography metric (facebook360_dep_tpu_torch/render/rephoto.py
and cli/compute_rephotography_errors.rephotography_scores) against the JAX
package's, float32 inputs made with numpy."""

import jax.numpy as jnp
import numpy as np
import pytest

from facebook360_dep_tpu.cli import compute_rephotography_errors as jcre
from facebook360_dep_tpu.render import rephoto as jr
from facebook360_dep_tpu.render import synthetic as jsyn
from facebook360_dep_tpu_torch.cli import compute_rephotography_errors as tcre
from facebook360_dep_tpu_torch.core import camera as tcam
from facebook360_dep_tpu_torch.render import rephoto as tr

from torch_parity import f32, port_rig, tt


def _pair(seed, shape=(20, 17, 3)):
    rng = np.random.RandomState(seed)
    x = f32(rng.rand(*shape))
    y = f32(np.clip(x + 0.15 * rng.randn(*shape), 0, 1))
    return x, y


@pytest.mark.parametrize("radius,sigma", [(1, 1.5), (2, 1.5), (3, 0.0)])
def test_gaussian_kernel_and_blur(radius, sigma):
    """Same taps, reflect-101 pad and shifted-sum order: 1e-6 on [0, 1] data."""
    np.testing.assert_allclose(tr.gaussian_kernel(radius, sigma).numpy(), np.asarray(jr.gaussian_kernel(radius, sigma)),
                               rtol=1e-7)
    x, _ = _pair(radius)
    for img in (x, x[..., 0]):
        np.testing.assert_allclose(tr.gaussian_blur(tt(img), radius, sigma).numpy(),
                                   np.asarray(jr.gaussian_blur(jnp.asarray(img), radius, sigma)), atol=1e-6)


@pytest.mark.parametrize("method", ["MSSIM", "NCC"])
@pytest.mark.parametrize("radius", [1, 2])
def test_score_maps_and_average(method, radius):
    """SSIM/NCC maps to 1e-6 (the structure term divides by sigma products
    as small as C3); masked channel means (float64 here, float32 numpy
    there) to 1e-6."""
    x, y = _pair(10 + radius)
    want = np.asarray(jr.compute_score_map(method, jnp.asarray(x), jnp.asarray(y), radius))
    got = tr.compute_score_map(method, tt(x), tt(y), radius)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    mask = np.random.RandomState(radius).rand(*x.shape[:2]) > 0.3
    np.testing.assert_allclose(tr.average_score(got, tt(mask)), jr.average_score(want, mask), atol=1e-6)
    np.testing.assert_allclose(tr.average_score(got), jr.average_score(want), atol=1e-6)
    empty = np.zeros(x.shape[:2], bool)
    np.testing.assert_array_equal(tr.average_score(got, tt(empty)), jr.average_score(want, empty))
    assert tr.format_results([0.91234, 0.5, 1.0]) == jr.format_results([0.91234, 0.5, 1.0])


def test_ssim_of_identical_images_is_one():
    x, _ = _pair(3)
    np.testing.assert_allclose(tr.compute_ssim(tt(x), tt(x), 1).numpy(), 1.0, atol=1e-4)


def test_rephotography_scores_match_jax():
    """tests/test_render.py's self-consistency run (4 cameras, 48x36, face
    24): per-camera and TOTAL MSSIM within 5e-4 of the JAX package's."""
    rig = jsyn.make_test_rig(num_cameras=4, resolution=(48, 36), ring_radius=0.2)
    colors, gt = jsyn.render_sphere_scene(rig, (48, 36), radius=5.0)
    colors, gt = np.array(colors, np.float32), np.array(gt, np.float32)
    j_scores, j_total = jcre.rephotography_scores(rig, colors, gt, method="MSSIM", face_size=24)
    t_scores, t_total = tcre.rephotography_scores(port_rig(tcam, rig), tt(colors), tt(gt), method="MSSIM",
                                                   face_size=24)
    assert np.all(t_total > 0.6)
    np.testing.assert_allclose(t_total, j_total, atol=5e-4)
    np.testing.assert_allclose(np.stack(t_scores), np.stack(j_scores), atol=5e-4)
