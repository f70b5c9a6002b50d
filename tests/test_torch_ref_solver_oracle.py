"""The reference-solver output oracle held on the port.

tests/test_ref_solver_oracle.py pins the JAX package's solver output to the
reference algorithm: tools/ref_cpu_baseline.cpp --mini_solver, a
single-level port of brute-force init (Derp.cpp:264-383), one Jacobi
ping-pong pass (Derp.cpp:403-541) and the masked median filter
(CvUtil.h:336), run on identical uint16-quantized pixels. This file runs
the same three scenes through the port's solver (on the CPU: the plain
twins of K1 and K2) with the original's bounds unchanged: agreement under
``REF_BOUNDS`` and dominance (the port's ground-truth rel RMSE at most 1.10x
the reference's). The helpers are tests/torch_oracle.py's, which
chip_smoke.py step 15 runs on the card.

Slow, as the original: 16 cameras at 256x192 and a C++ build. It skips, as
the original does, where g++, pkg-config or opencv4 is missing. Run with
``-m slow``; ``-s`` prints the readings.
"""

import pytest
import torch

import torch_oracle

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def tool_bin(tmp_path_factory):
    missing = torch_oracle.ref_tool_missing()
    if missing:
        pytest.skip(missing)
    return torch_oracle.build_ref_tool(str(tmp_path_factory.mktemp("bin") / "ref_cpu_baseline"))


@pytest.mark.parametrize("scene", ["sphere", "occluder", "outward"])
def test_solver_output_matches_reference(tool_bin, scene, tmp_path):
    rig, u16, gt = torch_oracle.ref_scene(scene)
    port_disp, var_floor = torch_oracle.run_port_mini_solver(rig, u16, torch.device("cpu"))
    ref_disp = torch_oracle.run_reference(tool_bin, rig, u16, var_floor, str(tmp_path))
    r = torch_oracle.check_against_reference(scene, port_disp, ref_disp, gt)
    print(f"{scene}: valid {r['valid']:.4f}; agree relRMSE {r['agree_rel_rmse']:.5f} median {r['agree_median']:.5f}; "
          f"GT relRMSE port {r['port_gt_rel_rmse']:.5f} vs reference {r['ref_gt_rel_rmse']:.5f}")
