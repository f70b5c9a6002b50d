"""The per-layer metric readers on a small canned trace."""

from __future__ import annotations

import os

import pytest

from depbench import coverage, harness, roofline, trace

K1 = "void (anonymous namespace)::project_sample_kernel<3, false>(float const*, int, int, int, float const*)"
K2 = "void (anonymous namespace)::ssd_combine_kernel<3>(float const*, unsigned char const*, float const*)"
K3 = "void (anonymous namespace)::cost_fused_kernel<false>(float4 const*, int, int, int, float const*)"
ADD = "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float> >(int, float*)"


# what K1's and K3's inputs need at each level of the canned trace (made-up counts)
NEEDS = {
    0: {"cameras": 16, "pixels": 30_000, "k1_src_px": 200_000, "k1_in_view_pairs": 240_000,
        "k1_valid_pairs": 90_000, "k3_src_px": 1_000, "k3_in_view_px": 500, "k3_in_view_pairs": 7_500,
        "k3_valid_pairs": 100},
    1: {"cameras": 16, "pixels": 7_500, "k1_src_px": 60_000, "k1_in_view_pairs": 120_000,
        "k1_valid_pairs": 50_000, "k3_src_px": 40_000, "k3_in_view_px": 7_500, "k3_in_view_pairs": 112_500,
        "k3_valid_pairs": 60_000},
}


def canned() -> trace.TraceData:
    # level 1 (100x75) on the host from 0 to 100 us, level 0 (200x150) from 100 to 300 us
    device = [(K1, 1_000, 20_000), (K2, 30_000, 1_000), (K3, 150_000, 100_000), (ADD, 260_000, 30_000),
              ("Memcpy DtoH (Device -> Pageable)", 292_000, 4_000)]
    return trace.TraceData(
        kernels=[(n, s, d) for n, s, d in device if trace.is_kernel(n)],
        busy=trace.merge([(s, s + d) for _, s, d in device], 0, 300_000),
        window=[(0, 300_000)], levels=[(1, 0, 100_000), (0, 100_000, 300_000)],
        level_sizes={0: (200, 150), 1: (100, 75)}, level_seconds=[{0: 2.0, 1: 0.5}], frames=1,
        cameras=16, finest_level=0,
        host_ops=[("aten::to", 55_000, 140_000), ("aten::add", 256_000, 259_000)], needs=NEEDS)


def read(name: str):
    return harness.load_module(os.path.join(harness.BASE, "metrics", name + ".py")).read(canned())


def test_level_times():
    assert read("finest_level_s") == 2.0
    assert read("coarser_levels_s") == 0.5


def test_device_counts_and_times():
    assert read("kernel_launches") == 4
    assert read("torch_ops_ms") == pytest.approx(0.03)
    busy = 20_000 + 1_000 + 100_000 + 30_000 + 4_000
    assert read("gpu_idle_pct") == pytest.approx(100 * (1 - busy / 300_000))


def test_rooflines():
    # K2 at 100x75 from 16 cameras: 1,642,500 bytes at 3.35 TB/s = 0.4903 us, over 1 us
    assert read("k2_ssd_combine.roofline_pct") == pytest.approx(100 * 1_642_500 / 3.35e12 / 1e-6)
    assert read("k1_project_sample.roofline_pct") == pytest.approx(
        100 * roofline.bound_s(*coverage.k1_work(NEEDS[1], 3)) / 20e-6)
    # K3 at level 0: 12 x 1,000 source bytes, 16 cameras' parameters, 12, rays and disparity of 30,000
    # pixels, dst and variance of the 500 in view, cost and confidence of 30,000: 741,548 bytes
    assert coverage.k3_work(NEEDS[0]) == (741_548, 70 * 7_500 + (18 + 50) * 100)
    assert read("k3_cost_fused.roofline_pct") == pytest.approx(100 * 741_548 / 3.35e12 / 100e-6)


def test_nothing_to_read_gives_nothing():
    t = canned()
    t.kernels = [k for k in t.kernels if "cost_fused" not in k[0]]
    mod = harness.load_module(os.path.join(harness.BASE, "metrics", "k3_cost_fused.roofline_pct.py"))
    assert mod.read(t) is None


def test_breakdown():
    b = trace.breakdown(canned())
    assert b["device_ops"][0] == ["cost_fused_kernel<false>", 100_000 / 1e9]
    # the longest idle gap, 31 to 150 us: its middle in level 1's range, aten::to the longest host op over it
    assert b["idle_gaps"][0] == ["derp level 1: aten::to", 119_000 / 1e9]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


@pytest.mark.parametrize("config", ["tiny4", "tinyftheta"])
def test_level_needs_counts_the_geometry(config):
    """Every count within what the full planes hold; the self pairs project every pixel in view onto
    itself; a rectilinear ring sees all of its frame, a fisheye only its image circle; the needs never
    ask for more than the full-plane work of roofline.py."""
    import torch

    from depbench.reference import camera as cam
    from depbench.tests import helpers

    c = harness.load_json(os.path.join(helpers.DATA, "configs", config + ".json"))
    maker = harness.load_module(os.path.join(harness.BASE, "rigs", c["rig"]["maker"] + ".py"))
    scene = harness.load_module(os.path.join(harness.BASE, "scenes", "sphere.py"))
    cams, ids = maker.make(c["rig"])
    cams = cam.normalize(cam.load_rig_text(cam.rig_json_text(cams, ids))[0])
    w, h = c["levels"]["widths"][0], c["levels"]["heights"][0]
    _, truth = scene.render(cams.to(None, torch.float32), (w, h), 7, 1)
    g = coverage.level_needs(cams, (w, h), truth)
    n, hw = len(ids), w * h
    assert g["cameras"] == n and g["pixels"] == hw
    in_view = g["k3_in_view_px"] * n
    if config == "tiny4":
        assert in_view == n * hw
    else:
        assert 0.2 * n * hw < in_view < 0.5 * n * hw  # the image circles: about 29% of the frames
    assert g["k1_in_view_pairs"] == in_view * n
    assert g["k1_valid_pairs"] - n * g["k3_valid_pairs"] == in_view  # the self pairs
    assert 0 < g["k3_valid_pairs"] <= g["k3_in_view_pairs"]
    assert 0 < g["k3_src_px"] <= (n - 1) * hw and g["k1_src_px"] <= n * hw
    for got, full in ((coverage.k1_work(g, 3), roofline.k1_work(n, 3, h, w, h, w, n)),
                      (coverage.k3_work(g), roofline.k3_work(n, h, w, h, w))):
        assert got[0] <= full[0] and got[1] <= full[1]


def test_time_between_traced_jobs_is_outside_the_window():
    """Two traced jobs: the harness's read-back between them counts neither as idle nor as a gap."""
    t = canned()
    t.window = [(0, 100_000), (200_000, 300_000)]
    t.busy = [(10_000, 50_000), (210_000, 250_000)]
    assert t.window_ns() == 200_000
    assert read_from("gpu_idle_pct", t) == pytest.approx(60.0)
    gaps = [g for _, g in trace.breakdown(t)["idle_gaps"]]
    assert sorted(gaps) == pytest.approx([10e-6, 10e-6, 50e-6, 50e-6])  # not the 100 us between the jobs


def read_from(name: str, t):
    return harness.load_module(os.path.join(harness.BASE, "metrics", name + ".py")).read(t)
