"""The input layers a cell lists beside the colours (``inputs``): the tree's files, the
arrays handed to the reference, the program's job over them, and the cells that list none.

Uses the test cell ``tiny4.fg`` (scene ``sphere_disk``, ``--use_foreground_masks true``).
"""

from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from depbench import harness
from depbench.tests import helpers

SEED = 2**31 + 4321
CPU = torch.device("cpu")
MASKS, BACKGROUND = "foreground_masks_levels", "background_disp_levels"


def _cell(name: str) -> harness.Cell:
    return harness.find_cell(name, helpers.bench_with_test_cells(), helpers.DATA)


def _tree(c: harness.Cell, root) -> harness.Tree:
    with ThreadPoolExecutor(max_workers=4) as pool:
        return harness.make_tree(c, os.path.join(root, "tree"), SEED, CPU, pool)


def _files(root: str) -> set[str]:
    return {os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs}


class _StubReference:
    """A reference module that records the keywords of every ``solve_pyramid`` call and
    returns all-NaN maps of the kept levels."""

    def __init__(self):
        self.calls = []

    def solve_pyramid(self, cams_norm, colors_by_level, sizes, full_height, min_depth, max_depth, device,
                      dtype=torch.float32, **kw):
        self.calls.append(kw)
        n = len(cams_norm.type_code)
        return {lv: np.full((n, sizes[lv][1], sizes[lv][0]), np.nan, np.float32) for lv in kw["keep"]}


@pytest.fixture
def stub_reference(monkeypatch):
    stub, load = _StubReference(), harness.load_module
    monkeypatch.setattr(harness, "load_module",
                        lambda path: stub if os.sep + "reference" + os.sep in path else load(path))
    return stub


def _fake_jobs(c: harness.Cell, tree: harness.Tree) -> list[harness.Job]:
    maps = {lv: np.full((len(tree.ids), c.size(lv)[1], c.size(lv)[0]), np.nan, np.float32) for lv in c.judged}
    return [harness.Job(frame, 0.0, {}, maps) for frame in c.frames]


def test_make_tree_writes_exactly_the_listed_inputs(tmp_path):
    """(a) every listed layer at every level, the masks a frame and for the warm-up, the
    background once; each file reads back as the Tree's array, the PFMs bit for bit."""
    from facebook360_dep_tpu_torch.core import io

    c = _cell("tiny4.fg")
    tree = _tree(c, tmp_path)
    frames = [harness.WARMUP_FRAME, *c.frames]
    want = {"rigs/rig_calibrated.json"}
    for level in c.levels:
        for cid in tree.ids:
            want |= {f"video/color_levels/level_{level}/{cid}/{f}.png" for f in frames}
            want |= {f"video/foreground_masks_levels/level_{level}/{cid}/{f}.png" for f in frames}
            want.add(f"background/disparity_levels/level_{level}/{cid}/000000.pfm")
    root = os.path.join(tmp_path, "tree")
    assert _files(root) == want
    assert set(tree.inputs) == {MASKS, BACKGROUND}
    assert set(tree.inputs[MASKS]) == set(c.frames) and set(tree.inputs[BACKGROUND]) == {harness.PLATE_FRAME}
    for level in c.levels:
        for i, cid in enumerate(tree.ids):
            for frame in c.frames:
                mask = tree.inputs[MASKS][frame][level]
                assert mask.dtype == np.bool_ and mask.shape == (len(tree.ids), c.size(level)[1], c.size(level)[0])
                got = io.read_mask(os.path.join(root, "video", "foreground_masks_levels", f"level_{level}", cid,
                                                frame + ".png"))
                np.testing.assert_array_equal(got, mask[i])
            d = os.path.join(root, "video", "foreground_masks_levels", f"level_{level}", cid)
            assert os.path.samefile(os.path.join(d, harness.WARMUP_FRAME + ".png"),
                                    os.path.join(d, c.frames[0] + ".png"))
            bg = tree.inputs[BACKGROUND][harness.PLATE_FRAME][level]
            assert bg.dtype == np.float32
            got = io.read_pfm(os.path.join(root, "background", "disparity_levels", f"level_{level}", cid,
                                           "000000.pfm"))
            assert got.shape == bg[i].shape and got.tobytes() == bg[i].tobytes()
    # the masks hold the disk, and only a part of each view
    assert all(0 < m.mean() < 0.5 for m in tree.inputs[MASKS][c.frames[0]].values())


def test_a_foreground_job_over_the_tree_writes_every_level(tmp_path):
    """(b) the program's derp_cli job, under --use_foreground_masks, over that tree on the CPU."""
    c = _cell("tiny4.fg")
    tree = _tree(c, tmp_path)
    out = os.path.join(tmp_path, "out")
    seconds = harness.solve(c, tree, out, c.frames[0], CPU)
    assert set(seconds) == set(c.levels)
    for level in c.levels:
        for cid in tree.ids:
            assert os.path.exists(os.path.join(out, "disparity_levels", f"level_{level}", cid, c.frames[0] + ".pfm"))
    finest = harness.judge.read_maps(out, c.levels[0], tree.ids, c.frames[0], c.size(c.levels[0])[::-1])
    assert np.isfinite(finest).mean() > 0.9


def test_judge_and_control_hand_the_reference_the_inputs(tmp_path, stub_reference):
    """(c) a frame's masks and the plate's background, the Tree's own arrays, as one keyword."""
    from depbench import control

    c = _cell("tiny4.fg")
    tree = _tree(c, tmp_path)
    harness.judge_jobs(c, tree, _fake_jobs(c, tree), CPU)
    control.solve(c, tree, os.path.join(tmp_path, "out"), harness.WARMUP_FRAME, CPU)
    assert len(stub_reference.calls) == len(c.frames) + 1
    for frame, kw in zip([*c.frames, c.frames[0]], stub_reference.calls):
        assert set(kw) == {"keep", "inputs"} and set(kw["inputs"]) == {MASKS, BACKGROUND}
        for t, src in ((MASKS, frame), (BACKGROUND, harness.PLATE_FRAME)):
            assert set(kw["inputs"][t]) == set(c.levels)
            for level in c.levels:
                assert kw["inputs"][t][level] is tree.inputs[t][src][level]
    # the two frames' masks differ: the disk moves
    assert not np.array_equal(tree.inputs[MASKS][c.frames[0]][0], tree.inputs[MASKS][c.frames[1]][0])


@pytest.mark.parametrize("name", ["tiny4.small", "tinyftheta.small"])
def test_cells_without_inputs_are_as_before(tmp_path, stub_reference, name):
    """(d) the tree holds the rig and the colours alone; the reference gets no ``inputs`` keyword."""
    c = _cell(name)
    assert c.inputs == []
    tree = _tree(c, tmp_path)
    root = os.path.join(tmp_path, "tree")
    assert sorted(os.listdir(root)) == ["rigs", "video"] and os.listdir(os.path.join(root, "video")) == ["color_levels"]
    assert tree.inputs == {} and harness.reference_inputs(c, tree, c.frames[0]) == {}
    harness.judge_jobs(c, tree, _fake_jobs(c, tree), CPU)
    assert stub_reference.calls == [{"keep": c.judged}] * len(c.frames)


def test_sphere_disk_masks_and_background():
    """(e) the masks are where the disk is nearer than the sphere, the background is the sphere's
    disparity, and outside the masks the scene is the sphere's."""
    from depbench.reference import camera as cam

    cfg = harness.load_json(os.path.join(helpers.DATA, "configs", "tiny4.json"))
    maker = harness.load_module(os.path.join(harness.BASE, "rigs", cfg["rig"]["maker"] + ".py"))
    sphere = harness.load_module(os.path.join(harness.BASE, "scenes", "sphere.py"))
    scene = harness.load_module(os.path.join(harness.BASE, "scenes", "sphere_disk.py"))
    cams, ids = maker.make(cfg["rig"])
    cams = cam.normalize(cam.load_rig_text(cam.rig_json_text(cams, ids))[0]).to(None, torch.float32)
    size = (cfg["levels"]["widths"][0], cfg["levels"]["heights"][0])
    centres = []
    for frame in (0, 5, 10):
        rgb, disp = scene.render(cams, size, SEED, frame)
        layers = scene.render_inputs(cams, size, SEED, frame)
        s_rgb, s_disp = sphere.render(cams, size, SEED, frame)
        mask, bg = layers["foreground_masks_levels"], layers["background_disp_levels"]
        assert mask.dtype == torch.bool and bg.dtype == torch.float32
        assert torch.equal(bg, s_disp)
        assert 0 < mask.float().mean() < 0.5
        assert torch.all(disp[mask] > bg[mask]) and torch.equal(disp[~mask], bg[~mask])
        assert torch.equal(rgb[~mask], s_rgb[~mask]) and not torch.equal(rgb[mask], s_rgb[mask])
        # the disk lies 2 to 2.5 m away along the rays that hit it
        assert torch.all((disp[mask] > 0.4) & (disp[mask] < 0.501))
        xs = torch.nonzero(mask[0])[:, 1].float()
        centres.append(float(xs.mean()))
    # it moves along +X: to the right in a view of a ring that looks -Z
    assert centres[0] < centres[1] < centres[2]


def test_a_job_of_several_frames_is_refused_at_load(tmp_path):
    """A job solves one frame, so a cell with frames_per_job 2 would read twice as fast: refused."""
    for sub in ("cells", "configs"):
        os.makedirs(tmp_path / sub)
    shutil.copy(os.path.join(helpers.DATA, "configs", "tiny4.json"), tmp_path / "configs")
    cell = harness.load_json(os.path.join(helpers.DATA, "cells", "tiny4.small.json"))
    with open(tmp_path / "cells" / "tiny4.small.json", "w") as f:
        json.dump({**cell, "frames_per_job": 2}, f)
    with pytest.raises(ValueError, match="sphere16.chunk8"):
        harness.find_cell("tiny4.small", helpers.bench_with_test_cells(), str(tmp_path))
    with open(tmp_path / "cells" / "tiny4.small.json", "w") as f:
        json.dump({**cell, "inputs": ["foreground_masks"]}, f)
    with pytest.raises(ValueError, match="unknown inputs"):
        harness.find_cell("tiny4.small", helpers.bench_with_test_cells(), str(tmp_path))
