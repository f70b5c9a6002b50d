"""The port's native host codecs (facebook360_dep_tpu_torch/stream/native.py,
built from its own copy of the C++ sources) against the JAX package's
library on the same numpy inputs made from a seed: faces, step maps,
simplified meshes, BC7 blocks, rasters and PIZ payloads are byte-equal.
Also the build: into a digest directory, atomic when several threads build
at once, and raising (never falling back) where g++ is missing or fails."""

import os
import shutil
import threading

import numpy as np
import pytest

from facebook360_dep_tpu.stream import native as jnative
from facebook360_dep_tpu_torch.stream import native as tnative

import torch_parity  # noqa: F401  (thread count)


def _proxy(kind, h=37, w=45, seed=0):
    """Depth proxies: smooth with a tear, noise with NaN holes, and exact
    ties (the sorting network's first-min / last-max rules)."""
    rng = np.random.default_rng(seed)
    if kind == "smooth_tear":
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        z = 100.0 + 10.0 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
        z[: h // 2] *= 2.0
        return z.astype(np.float32)
    if kind == "noise_nan":
        z = (100 + 30 * rng.random((h, w))).astype(np.float32)
        z[rng.random((h, w)) < 0.05] = np.nan
        return z
    return rng.integers(1, 4, (h, w)).astype(np.float32)  # ties everywhere


def _grid_mesh(h=40, w=52, seed=1):
    """An equi-error-like vertex grid with two quads a cell."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    z = 50.0 + 5.0 * np.sin(xx / 9.0) + 3.0 * np.cos(yy / 6.0) + rng.random((h, w)).astype(np.float32) * 0.01
    v = np.stack([xx, yy, z], -1).reshape(-1, 3).astype(np.float32)
    return v, tnative.build_faces(z, 0.95)


@pytest.mark.parametrize("kind", ["smooth_tear", "noise_nan", "ties"])
@pytest.mark.parametrize("tear_ratio", [0.0, 0.95])
def test_build_faces_byte_equal(kind, tear_ratio):
    z = _proxy(kind)
    got, want = tnative.build_faces(z, tear_ratio), jnative.build_faces(z, tear_ratio)
    assert got.dtype == np.uint32 and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("kind", ["smooth_tear", "noise_nan", "ties"])
@pytest.mark.parametrize("tol_rel", [2e-4, 1e-3])
def test_build_adaptive_faces_and_step_map_byte_equal(kind, tol_rel):
    z = _proxy(kind, h=81, w=97, seed=3)
    f_t, s_t = tnative.build_adaptive_faces(z, 0.95, tol_rel, want_step=True)
    f_j, s_j = jnative.build_adaptive_faces(z, 0.95, tol_rel, want_step=True)
    assert f_t.tobytes() == f_j.tobytes()
    assert s_t.dtype == s_j.dtype and np.array_equal(s_t, s_j)


@pytest.mark.parametrize("target", [300, 1500])
def test_simplify_mesh_byte_equal(target):
    v, f = _grid_mesh()
    vt, ft = tnative.simplify_mesh(v, f, target)
    vj, fj = jnative.simplify_mesh(v, f, target)
    assert len(ft) <= target
    assert vt.tobytes() == vj.tobytes() and ft.tobytes() == fj.tobytes()


def test_simplify_mesh_over_budget_warns(caplog):
    """A budget the collapse cannot reach keeps a valid mesh and logs the
    count reached, as the JAX library does."""
    v, f = _grid_mesh(h=6, w=7)
    with caplog.at_level("WARNING", logger="stream"):
        vt, ft = tnative.simplify_mesh(v, f, 2)
    vj, fj = jnative.simplify_mesh(v, f, 2)
    assert vt.tobytes() == vj.tobytes() and ft.tobytes() == fj.tobytes()
    assert len(ft) > 2 and "budget not reached" in caplog.text


def test_bc7_blocks_and_decode_byte_equal():
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:48, 0:64]
    rgba = np.stack([128 + 100 * np.sin(xx / 5.0), 128 + 100 * np.cos(yy / 4.0),
                     rng.integers(0, 256, (48, 64)), np.full((48, 64), 255)], -1).astype(np.uint8)
    bt, bj = tnative.compress_bc7(rgba), jnative.compress_bc7(rgba)
    assert bt.tobytes() == bj.tobytes()
    dt, dj = tnative.decompress_bc7(bt, 64, 48), jnative.decompress_bc7(bj, 64, 48)
    assert dt.tobytes() == dj.tobytes()
    with pytest.raises(ValueError):
        tnative.compress_bc7(rgba[:47])


def test_rasterize_mesh_byte_equal():
    v, f = _grid_mesh()
    vs, fs = tnative.simplify_mesh(v, f, 800)
    for w, h, sx, sy in ((52, 40, 1.0, 1.0), (26, 20, 0.5, 0.5), (61, 33, 61 / 52, 33 / 40)):
        got, want = tnative.rasterize_mesh(vs, fs, w, h, sx, sy), jnative.rasterize_mesh(vs, fs, w, h, sx, sy)
        assert got.tobytes() == want.tobytes()
        assert np.isfinite(got).mean() > 0.5
    bad = fs.copy()
    bad[0, 0] = len(vs)
    with pytest.raises(ValueError, match="out of range"):
        tnative.rasterize_mesh(vs, bad, 52, 40)


@pytest.mark.parametrize("sizes", [[2], [1, 1, 1], [2, 1]])
def test_piz_payload_byte_equal_and_round_trip(sizes):
    """FLOAT (2 u16 a pixel) and HALF (1) planes: the same payload from both
    libraries, and each decodes the other's."""
    rng = np.random.default_rng(sum(sizes))
    nx, ny = 29, 13
    smooth = np.sin(np.arange(nx * ny * sum(sizes)) / 17.0)
    planes = (smooth * 3000 + 30000 + rng.integers(0, 40, smooth.size)).astype(np.uint16)
    pt, pj = tnative.piz_compress(planes, nx, ny, sizes), jnative.piz_compress(planes, nx, ny, sizes)
    assert pt == pj
    assert np.array_equal(tnative.piz_uncompress(pj, nx, ny, sizes), planes)
    assert np.array_equal(jnative.piz_uncompress(pt, nx, ny, sizes), planes)
    with pytest.raises(ValueError, match="malformed PIZ"):
        tnative.piz_uncompress(pt[:3], nx, ny, sizes)


def test_library_builds_into_its_digest_directory():
    path = tnative.build()
    assert path.parent.name == tnative._digest() and path.parent.parent == tnative.NATIVE / "_build"
    assert path.exists()


def test_build_raises_without_gxx(monkeypatch):
    monkeypatch.setattr(tnative, "_digest", lambda: "no-gxx-probe")
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tnative.build()
    assert not (tnative.NATIVE / "_build" / "no-gxx-probe").exists()


def test_build_failure_raises_with_the_compiler_output(monkeypatch, tmp_path):
    (tmp_path / "broken.cpp").write_text("extern \"C\" int broken( { return 0; }\n")
    monkeypatch.setattr(tnative, "NATIVE", tmp_path)
    monkeypatch.setattr(tnative, "SOURCES", ("broken.cpp",))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        tnative.build()
    assert "broken.cpp" in str(e.value)
    assert not list((tmp_path / "_build").glob("*/*.so"))


def test_concurrent_builds_leave_one_whole_library(monkeypatch, tmp_path):
    """Three threads build the same sources into an empty tree at once:
    each returns the same path, no temporary file is left, and the library
    loads with its entry points."""
    for name in tnative.SOURCES:
        shutil.copy(tnative.NATIVE / name, tmp_path / name)
    monkeypatch.setattr(tnative, "NATIVE", tmp_path)
    paths, errors = [], []

    def run():
        try:
            paths.append(tnative.build())
        except Exception as e:  # noqa: BLE001  (reported below)
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(set(paths)) == 1
    assert os.listdir(paths[0].parent) == [paths[0].name]
    import ctypes

    lib = ctypes.CDLL(str(paths[0]))
    assert hasattr(lib, "png_unfilter") and hasattr(lib, "piz_uncompress")
