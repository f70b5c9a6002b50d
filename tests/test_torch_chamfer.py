"""The chamfer labels of the foreground pass's init between levels, on the CPU.

``ops/warp_cuda.py::chamfer_labels`` runs the kernel of ``csrc/chamfer.cu``
on a CUDA tensor and its plain twin ``chamfer_labels_plain`` on a CPU one;
the twin is held here to the JAX package's chamfer
(``facebook360_dep_tpu/depth/pipeline.py::_nearest_valid_index``) and to
``cv2.distanceTransformWithLabels``, ties included, and the wrapper's
checks are exercised. The init on tensors (``pipeline._upsample_fg_tensors``,
what the estimator runs on its device) is held to the JAX package's
``upsample_disparity_fg``, map by map, bit for bit, and its counts to the
holes and maps that the inputs give, at the foreground configuration's level
shapes scaled down and at a ragged shape. tests/test_torch_cuda.py holds the
kernel to the twin on the card."""

import cv2
import numpy as np
import pytest
import torch

from facebook360_dep_tpu.depth import pipeline as jpipe
from facebook360_dep_tpu_torch.depth import pipeline
from facebook360_dep_tpu_torch.ops import warp_cuda as wc

KINDS = ["sparse", "half", "dense", "blobs", "lattice", "pair", "single", "empty", "full"]
SIZES = [(37, 53), (60, 80), (5, 9), (1, 12), (13, 1), (2, 2), (19, 257)]


def _valid(rng, kind, h, w):
    if kind == "blobs":
        yy, xx = np.mgrid[0:h, 0:w]
        valid = np.zeros((h, w), bool)
        for _ in range(3):
            cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(1, 8)
            valid |= (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        return valid
    valid = np.zeros((h, w), bool)
    if kind == "lattice":  # every pixel midway between two valid ones is a tie
        valid[1::6, 2::6] = True
    elif kind == "pair":  # two valid pixels of one row: a column of ties between them
        valid[h // 2, 0] = valid[h // 2, w - 1] = True
    elif kind == "single":
        valid[rng.randint(h), rng.randint(w)] = True
    elif kind == "full":
        valid[:] = True
    elif kind != "empty":
        valid = rng.rand(h, w) < {"sparse": 0.03, "half": 0.5, "dense": 0.95}[kind]
    return valid


def _jax_labels(valid):
    """The JAX package's nearest valid pixel of each map as a flat index
    y * W + x; -1 in a map with no valid pixel (which it never labels)."""
    maps = valid.reshape((-1,) + valid.shape[-2:])
    out = np.full(maps.shape, -1, np.int64)
    for v, o in zip(maps, out):
        if v.any():
            _, (iy, ix) = jpipe._nearest_valid_index(v)
            o[:] = iy * v.shape[-1] + ix
    return out.reshape(valid.shape)


def _opencv_labels(valid):
    """cv2's nearest zero pixel of ~valid (DIST_L2, DIST_LABEL_PIXEL) as a flat index y * W + x."""
    _, lab = cv2.distanceTransformWithLabels((~valid).astype(np.uint8), cv2.DIST_L2, 3,
                                             labelType=cv2.DIST_LABEL_PIXEL)
    zy, zx = np.nonzero(valid)  # the labels number the zero pixels in raster order, from 1
    return (zy * valid.shape[1] + zx)[lab - 1]


def _twin(valid):
    return wc.chamfer_labels_plain(torch.from_numpy(valid)).numpy()


@pytest.mark.parametrize("kind", KINDS)
def test_twin_equals_numpy_chamfer_and_opencv(kind):
    """One map at a time, at odd and degenerate sizes: the twin's labels are
    the JAX package's chamfer's and cv2's, ties included; -1 in a map with
    no valid pixel."""
    rng = np.random.RandomState(len(kind))
    for h, w in SIZES:
        valid = _valid(rng, kind, h, w) if min(h, w) > 4 or kind in ("empty", "full") else rng.rand(h, w) < 0.3
        got = _twin(valid[None])[0]
        assert got.dtype == np.int32
        if valid.any():
            np.testing.assert_array_equal(got, _jax_labels(valid), err_msg=f"{kind} {h}x{w}")
            np.testing.assert_array_equal(got, _opencv_labels(valid), err_msg=f"{kind} {h}x{w}")
        else:
            assert (got == -1).all()


@pytest.mark.parametrize("kind", KINDS)
def test_twin_labels_a_stack_map_by_map(kind):
    """A stack in which some maps need no chamfer (no valid pixel, every
    pixel valid, one valid pixel) gives each map its own labels."""
    rng = np.random.RandomState(100 + len(kind))
    h, w = 30, 41
    stack = np.stack([_valid(rng, kind, h, w), np.zeros((h, w), bool), np.ones((h, w), bool),
                      _valid(rng, "single", h, w), _valid(rng, kind, h, w)])
    got = _twin(stack)
    for i in range(len(stack)):
        np.testing.assert_array_equal(got[i], _twin(stack[i:i + 1])[0], err_msg=str(i))
    np.testing.assert_array_equal(got, _jax_labels(stack))
    assert (got[1] == -1).all() and (got[2] == np.arange(h * w).reshape(h, w)).all()


def test_wrapper_on_the_cpu_runs_the_twin_and_launches_nothing():
    valid = torch.from_numpy(_valid(np.random.RandomState(5), "blobs", 23, 35))[None].repeat(3, 1, 1)
    wc.reset_launch_counts()
    got = wc.chamfer_labels(valid)
    assert torch.equal(got, wc.chamfer_labels_plain(valid)) and got.dtype == torch.int32
    assert wc.LAUNCHES["chamfer"] == 0 and not wc.LAUNCHES_BY_SHAPE


@pytest.mark.parametrize("bad,match", [
    (torch.zeros((2, 5, 6), dtype=torch.uint8), "dtype"),
    (torch.zeros((2, 5, 6), dtype=torch.float32), "dtype"),
    (torch.zeros((5, 6), dtype=torch.bool), "shape"),
    (torch.zeros((1, 2, 5, 6), dtype=torch.bool), "shape"),
    (torch.zeros((2, 6, 5), dtype=torch.bool).transpose(1, 2), "contiguous"),
    (torch.zeros((0, 5, 6), dtype=torch.bool), "shape"),
    (torch.zeros((1, 5, 0), dtype=torch.bool), "shape"),
    (torch.zeros((1, 2, wc.CHAMFER_MAX_WIDTH + 1), dtype=torch.bool), "shape"),
    (torch.zeros((1, 5, 6), dtype=torch.bool, device="meta"), "meta"),
])
def test_wrapper_rejects_bad_inputs(bad, match):
    with pytest.raises(ValueError, match=match):
        wc.chamfer_labels(bad)


# (fine (w, h), coarse (w, h)) pairs of sphere16fg's pyramid (widths 2048 ... 50,
# heights (3 w + 2) // 4) with the widths cut by 8, and a ragged pair
SCALED = [2048 // 8, 1024 // 8, 512 // 8, 256 // 8, 200 // 8, 128 // 8, 100 // 8, 80 // 8, 60 // 8, 50 // 8]
LEVEL_PAIRS = [((w, (3 * w + 2) // 4), (c, (3 * c + 2) // 4)) for w, c in zip(SCALED, SCALED[1:])]
LEVEL_PAIRS += [((61, 45), (40, 23))]


def _disks(n, w, h, phase):
    """(n, h, w) masks of one disk a map, moving from map to map, as the
    foreground's masks are rendered at each level independently."""
    v, u = (np.mgrid[0:h, 0:w] + 0.5) / np.array([h, w])[:, None, None]
    out = np.zeros((n, h, w), bool)
    for i in range(n):
        cu, cv = 0.2 + 0.6 * ((i * 0.37 + phase) % 1), 0.3 + 0.05 * i
        out[i] = (u - cu) ** 2 + ((v - cv) * h / w) ** 2 < 0.22 ** 2
    return out


def _init_case(fine, coarse, seed):
    rng = np.random.RandomState(seed)
    (w, h), (cw, ch) = fine, coarse
    n = 7
    disp = (rng.rand(n, ch, cw) * 0.3 + 0.1).astype(np.float32)
    disp[rng.rand(n, ch, cw) < 0.05] = np.nan
    # the coarser masks at their own resolution, so their edges disagree with the finer ones'
    mask = _disks(n, cw, ch, 0.1) & (rng.rand(n, ch, cw) < 0.97)
    mask_up = _disks(n, w, h, 0.1)
    mask_up[1] = False     # no mask: nothing to fill
    mask[2] = False        # no coarser mask: no valid pixel, the holes take the plate
    mask_up[3] = True      # all mask, the coarser one a disk: the chamfer fills the rest
    mask[4] = mask_up[4] = True  # full masks: holes only where the coarser map is NaN
    disp[4, 0, 0] = np.nan
    bg = (rng.rand(n, h, w) * 0.1).astype(np.float32)
    bg[:, :2, :3] = np.nan
    return disp, mask, mask_up, bg


def _jax_init(disp, mask, mask_up, bg, size_wh):
    """The JAX package's init between levels of each map, stacked."""
    return np.stack([jpipe.upsample_disparity_fg(*one, size_wh) for one in zip(disp, mask, mask_up, bg)])


def _holes_and_swept(disp, mask, mask_up, size_wh):
    """The in-mask holes of the maps that have a hole and a valid pixel
    after the nearest upsample (cv2's), and those maps' pixels."""
    d_up = np.stack([cv2.resize(np.where(m, d, np.float32(np.nan)), size_wh, interpolation=cv2.INTER_NEAREST)
                     for d, m in zip(disp, mask)])
    valid = np.isfinite(d_up) & mask_up
    invalid = mask_up & ~valid
    todo = invalid.any(axis=(1, 2)) & valid.any(axis=(1, 2))
    return int(invalid[todo].sum()), int(todo.sum()) * size_wh[0] * size_wh[1]


@pytest.mark.parametrize("fine,coarse", LEVEL_PAIRS)
def test_init_on_tensors_equals_the_numpy_init(fine, coarse):
    """The init the estimator runs on its device, here on CPU tensors, gives
    the JAX package's init's bits (NaN positions included), and counts the
    in-mask holes and the maps' pixels that the inputs give."""
    disp, mask, mask_up, bg = _init_case(fine, coarse, fine[0])
    want = _jax_init(disp, mask, mask_up, bg, fine)
    holes, swept = _holes_and_swept(disp, mask, mask_up, fine)
    got, got_holes, got_swept = pipeline._upsample_fg_tensors(
        *(torch.from_numpy(a) for a in (disp, mask, mask_up, bg)), fine)
    assert got.dtype == torch.float32 and got.shape == (7, fine[1], fine[0])
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert (got_holes, got_swept) == (holes, swept)
    assert holes > 0 and swept >= fine[0] * fine[1]


def test_init_on_tensors_skips_the_chamfer_where_no_map_has_a_hole(monkeypatch):
    """Maps whose masks hold no hole, or no valid pixel, are not chamfered:
    no labels are made and nothing is counted as swept."""
    def no_chamfer(valid):
        raise AssertionError("chamfer called")

    monkeypatch.setattr(pipeline, "_chamfer_labels", no_chamfer)
    disp, mask, mask_up, bg = _init_case((40, 30), (20, 15), 3)
    disp[:] = 0.25
    mask_up = mask_up & np.repeat(np.repeat(mask, 2, 1), 2, 2)  # every in-mask pixel valid
    mask_up[2] = True  # and one map with no valid pixel
    got, holes, swept = pipeline._upsample_fg_tensors(*(torch.from_numpy(a) for a in (disp, mask, mask_up, bg)),
                                                      (40, 30))
    want = _jax_init(disp, mask, mask_up, bg, (40, 30))
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert (holes, swept) == _holes_and_swept(disp, mask, mask_up, (40, 30)) == (0, 0)


def test_init_on_the_cpu_calls_the_host_chamfer(monkeypatch):
    """On the CPU the init labels through ``pipeline._nearest_valid_index``,
    looked up when called: a replacement there (as the benchmark's planted
    faults make one) changes the init."""
    calls = []
    real = pipeline._nearest_valid_index

    def counted(valid):
        calls.append(valid.shape)
        return real(valid)

    monkeypatch.setattr(pipeline, "_nearest_valid_index", counted)
    disp, mask, mask_up, bg = _init_case((40, 30), (20, 15), 4)
    tensors = [torch.from_numpy(a) for a in (disp, mask, mask_up, bg)]
    wc.reset_launch_counts()
    pipeline._upsample_fg_tensors(*tensors, (40, 30))
    assert len(calls) == 1 and calls[0][1:] == (30, 40) and wc.LAUNCHES["chamfer"] == 0
