"""The reference's scalar cost oracle held on the port.

tests/test_cost_oracle.py holds the JAX package's ``cost_for_disparity`` to
a line-faithful numpy port of the reference's computeCost
(Derp.cpp:104-226); tests/torch_oracle.py is its JAX-free copy on the port's
camera. Here:

- the copy equals the original on the same pixels of both rigs, in both
  patch modes (1e-9 relative: float64 cameras in both, the same numpy
  sums), so the two cannot drift apart (one 'perpixel' pixel a rig: the
  JAX original takes seconds for each);
- the port's ``cost_for_disparity`` (on the CPU: the plain twins of K1 and
  K2) meets the original bounds: within 5e-4 * (1 + |want|) of the
  'perpixel' oracle on the translation rig with at least 20 pixels
  checked, and on a rig with real parallax a median gap under 0.02 from
  the literal 'center' oracle with more than 90% of the pixels under 0.2.

The JAX originals are marked slow for JAX's per-op compiles; these run in
tier-1 (a few seconds each). chip_smoke.py step 15 holds K1, K2 and K3 on
the card to the same copy with the same bounds.
"""

import numpy as np
import pytest
import torch

from facebook360_dep_tpu.core import camera as jcam
from facebook360_dep_tpu.render import synthetic as jsyn
from facebook360_dep_tpu_torch.core import camera as tcam
from facebook360_dep_tpu_torch.ops import cost as tcost
from facebook360_dep_tpu_torch.render import synthetic as tsyn

import test_cost_oracle as joracle
import torch_oracle
from torch_parity import port_rig


def _port_cost_map(rig, imgs, disparity):
    ctx, variance = torch_oracle.one_dst_cost_context(rig, imgs, 0, torch.device("cpu"))
    return tcost.cost_for_disparity(ctx, disparity)[0][0].numpy(), variance


def _same_rig(trig, jrig):
    for name in tcam.Camera._fields:
        np.testing.assert_allclose(getattr(trig.cameras, name).numpy(), np.asarray(getattr(jrig.cameras, name)),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("rig_name", ["translation", "general"])
def test_oracle_copy_equals_original(rig_name):
    size = (64, 48)
    if rig_name == "translation":
        jrig = joracle._translation_rig(4, size)
        trig = torch_oracle._translation_rig(4, size)
        imgs = torch_oracle._smooth_images(4, size[1], size[0])
        np.testing.assert_array_equal(imgs, joracle._smooth_images(4, size[1], size[0]))
        disparity = 0.2
    else:
        jrig = jsyn.make_test_rig(num_cameras=4, resolution=size, ring_radius=0.1)
        trig = port_rig(tcam, jrig)
        colors, gt = jsyn.render_sphere_scene(jrig, size, radius=5.0)
        imgs = np.asarray(colors, np.float32)
        disparity = float(np.nanmedian(np.asarray(gt[0])))
    _same_rig(trig, jrig)
    jn, tn = jcam.normalize_rig(jrig), tcam.normalize_rig(trig)
    variance = np.random.RandomState(2).rand(size[1], size[0]).astype(np.float32) * 1e-3
    rng = np.random.RandomState(5)
    finite = 0
    # the JAX oracle takes ~3.5 s a 'perpixel' pixel (27 eager reprojections)
    for mode, pixels in (("perpixel", 1), ("center", 5)):
        for _ in range(pixels):
            x, y = int(rng.randint(6, size[0] - 6)), int(rng.randint(6, size[1] - 6))
            want = joracle.scalar_cost_oracle(jn, imgs, variance, 0, disparity, x, y, patch_mode=mode)
            got = torch_oracle.scalar_cost_oracle(tn, imgs, variance, 0, disparity, x, y, patch_mode=mode)
            assert (got[0] >= 1e30) == (want[0] >= 1e30) and got[1] == pytest.approx(want[1], rel=1e-12)
            if want[0] < 1e30:
                assert got[0] == pytest.approx(want[0], rel=1e-9), (mode, x, y)
                finite += 1
    assert finite >= 4


def test_oracle_matches_cost_for_disparity_translation_rig():
    """The tight parity of the combine/trust/confidence semantics: any
    residual beyond float32 arithmetic is a bug in the SSD/combine chain."""
    checked, worst = torch_oracle.check_translation_rig(_port_cost_map)
    assert checked >= 20 and worst <= 5e-4


def test_oracle_deviation_bounded_on_general_rig():
    """On a rig with real parallax the documented sampling deviations
    (PARITY.md) stay small away from the FOV edges."""
    size = (64, 48)
    rig = tsyn.make_test_rig(num_cameras=4, resolution=size, ring_radius=0.1)
    nrig = tcam.normalize_rig(rig)
    colors, gt = tsyn.render_sphere_scene(rig, size, radius=5.0)
    colors = colors.numpy()
    disparity = float(np.nanmedian(gt[0].numpy()))
    c_map, variance = _port_cost_map(nrig, colors, disparity)
    n, median, share = torch_oracle.check_general_rig(nrig, colors, disparity, c_map, variance)
    assert n >= 25 and median < 0.02 and share > 0.9
