"""The frame job's files on the estimator's pool of host threads
(facebook360_dep_tpu_torch/depth/pipeline.py, core/io.py, core/png.py):
the pooled reads equal the serial stack of ``io.read_color`` /
``io.read_mask`` / ``io.read_disparity`` byte for byte, in camera order
whatever order the threads finish in; a missing or corrupt file raises the
serial path's exception, naming the path; the pooled PFM writes are
``io.write_disparity``'s bytes; a derp_cli pyramid writes the same PFMs
with a pool of one thread and of eight, and the pool is shut down when the
run ends; ``png.decode``'s inflate size hint is exact and changes no
decode. Tolerance: exact."""

import os
import struct
import threading
import time
import types
import zlib

import numpy as np
import pytest

from facebook360_dep_tpu_torch.cli import derp_cli
from facebook360_dep_tpu_torch.core import camera as tcam
from facebook360_dep_tpu_torch.core import imagetypes, io, png
from facebook360_dep_tpu_torch.depth import pipeline
from facebook360_dep_tpu_torch.render import synthetic as tsyn

from test_torch_png import _bgr, _build_png, _image, _png_bytes

SIZE = (37, 23)  # odd width and height
FRAME = "000000"
# color PNG kinds: (dtype, stored channels)
KINDS = {"rgb16": (np.uint16, 3), "rgb8": (np.uint8, 3), "rgba16": (np.uint16, 4), "rgba8": (np.uint8, 4),
         "gray16": (np.uint16, 1), "gray8": (np.uint8, 1), "graya16": (np.uint16, 2), "graya8": (np.uint8, 2)}


def _write_tree(root, kind, n=4, size=SIZE, seed=0):
    """A one-level tree of ``n`` cameras: colors of ``kind``, 8-bit masks and
    PFM plates with NaNs, and the rig. Returns the rig."""
    dtype, channels = KINDS[kind]
    w, h = size
    rig = tsyn.make_test_rig(n, size, ring_radius=0.3)
    rng = np.random.RandomState(seed)
    for i, cam_id in enumerate(rig.ids):
        plate = rng.rand(h, w).astype(np.float32)
        plate[rng.rand(h, w) < 0.05] = np.nan
        for image_type, name, write, value in (
                ("color_levels", "000000.png", io.write_png, _image(dtype, channels, seed=seed + i, h=h, w=w)),
                ("foreground_masks_levels", "000000.png", io.write_png,
                 (rng.rand(h, w) < 0.3).astype(np.uint8) * np.uint8(255)),
                ("background_disp_levels", "000000.pfm", io.write_pfm, plate)):
            d = imagetypes.image_dir(root, image_type, 0, cam_id)
            os.makedirs(d, exist_ok=True)
            write(os.path.join(d, name), value)
    os.makedirs(os.path.join(root, "rigs"), exist_ok=True)
    tcam.save_rig(os.path.join(root, "rigs/rig_calibrated.json"), rig)
    return rig


def _estimator(root, out, **kw):
    return pipeline.DepthEstimator(pipeline.DepthEstimatorOptions(input_root=root, output_root=out, **kw),
                                   device="cpu")


def _paths(root, image_type, rig):
    return [io.frame_path(imagetypes.image_dir(root, image_type, 0, c), FRAME) for c in rig.ids]


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_pooled_reads_equal_the_serial_stacks(tmp_path, kind):
    root = str(tmp_path / "in")
    rig = _write_tree(root, kind)
    est = _estimator(root, str(tmp_path / "out"))
    colors = _paths(root, "color_levels", rig)
    serial = np.stack([io.read_color(p) for p in colors])
    # the stack the solver gets: RGB, alpha dropped, gray expanded, each camera decoded into its slot
    got = est.load_colors(0, FRAME)
    assert got.flags.c_contiguous
    _same(got, serial[..., :3])
    # the generic pooled loader keeps each loader's result, alpha included
    _same(est._load_level_images(est.opts.color, 0, rig, FRAME, io.read_color), serial)
    _same(est.load_fg_masks(0, FRAME, rig),
          np.stack([io.read_mask(p) for p in _paths(root, "foreground_masks_levels", rig)]))
    _same(est.load_bg_disp(0), np.stack([io.read_disparity(p) for p in _paths(root, "background_disp_levels", rig)]))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_read_color_into_a_slot_is_read_color(tmp_path, kind):
    dtype, channels = KINDS[kind]
    p = str(tmp_path / "c.png")
    io.write_png(p, _image(dtype, channels, seed=3, h=SIZE[1], w=SIZE[0]))
    stack = np.full((2, SIZE[1], SIZE[0], 3), np.nan, np.float32)
    io.read_color_into(p, stack[1])
    _same(stack[1], np.ascontiguousarray(io.read_color(p)[..., :3]))
    assert np.isnan(stack[0]).all()  # the other slot is untouched
    with pytest.raises(ValueError, match="c.png"):
        io.read_color_into(p, np.empty((SIZE[1], SIZE[0] + 1, 3), np.float32))


def test_camera_order_holds_when_earlier_cameras_finish_last(tmp_path, monkeypatch):
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(8)))
    root = str(tmp_path / "in")
    rig = _write_tree(root, "rgb16", n=6)
    est = _estimator(root, str(tmp_path / "out"))
    assert est.io_workers == 8
    finished, lock = [], threading.Lock()

    def slow(path):
        i = rig.ids.index(os.path.basename(os.path.dirname(path)))
        time.sleep(0.1 * (len(rig.ids) - i))  # camera 0 sleeps longest
        with lock:
            finished.append(i)
        return np.full((2, 2), i, np.int64)

    got = est._load_level_images(est.opts.color, 0, rig, FRAME, slow)
    assert finished == list(range(len(rig.ids)))[::-1]  # the threads ran at once, the last camera done first
    _same(got, np.stack([np.full((2, 2), i, np.int64) for i in range(len(rig.ids))]))


def _break(path, how):
    """Make ``path`` missing (renamed to another frame, so the directory
    still names the format) or corrupt (its data cut in half)."""
    if how == "missing":
        os.rename(path, os.path.join(os.path.dirname(path), "000001" + os.path.splitext(path)[1]))
    else:
        data = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(data[:len(data) // 2])


@pytest.mark.parametrize("how", ["missing", "corrupt"])
@pytest.mark.parametrize("camera", [0, 2])
@pytest.mark.parametrize("layer", ["color_levels", "foreground_masks_levels", "background_disp_levels"])
def test_a_broken_file_raises_as_the_serial_path(tmp_path, layer, camera, how):
    root = str(tmp_path / "in")
    rig = _write_tree(root, "rgb16")
    est = _estimator(root, str(tmp_path / "out"))
    path = _paths(root, layer, rig)[camera]
    _break(path, how)
    loader, load = {"color_levels": (io.read_color, lambda: est.load_colors(0, FRAME)),
                    "foreground_masks_levels": (io.read_mask, lambda: est.load_fg_masks(0, FRAME, rig)),
                    "background_disp_levels": (io.read_disparity, lambda: est.load_bg_disp(0))}[layer]
    with pytest.raises(Exception) as want:
        np.stack([loader(io.frame_path(imagetypes.image_dir(root, layer, 0, c), FRAME)) for c in rig.ids])
    with pytest.raises(type(want.value)) as got:
        load()
    assert type(got.value) is type(want.value) and str(got.value) == str(want.value)
    assert path in str(got.value) or any(path in note for note in getattr(got.value, "__notes__", ()))


@pytest.mark.parametrize("formats", ["pfm", "png,pfm"])
def test_pooled_writes_are_write_disparity_bytes(tmp_path, formats):
    root = str(tmp_path / "in")
    rig = _write_tree(root, "rgb8", n=5)
    est = _estimator(root, str(tmp_path / "out"), output_formats=formats)
    rng = np.random.RandomState(1)
    disp = (rng.rand(5, SIZE[1], SIZE[0]) * 1.2 - 0.1).astype(np.float32)
    disp[rng.rand(*disp.shape) < 0.05] = np.nan
    est.save_results(0, FRAME, {"disparity": disp})
    exts = sorted(set(formats.split(",")) | {"pfm"})
    for i, cam_id in enumerate(rig.ids):
        for ext in exts:
            want = str(tmp_path / f"serial_{cam_id}.{ext}")
            io.write_disparity(want, disp[i])
            got = imagetypes.gen_filename(str(tmp_path / "out"), "disparity_levels", 0, cam_id, FRAME, ext)
            assert open(got, "rb").read() == open(want, "rb").read(), (cam_id, ext)


def _pyramid(root):
    """4 cameras, two levels (24x18, 16x12), PNG16 colors of the sphere."""
    levels = {0: (24, 18), 1: (16, 12)}
    rig = tsyn.make_test_rig(4, levels[0], ring_radius=0.3)
    colors, _ = tsyn.render_sphere_scene(rig, levels[0], radius=5.0)
    for level, size in levels.items():
        for i, cam_id in enumerate(rig.ids):
            d = imagetypes.image_dir(root, "color_levels", level, cam_id)
            os.makedirs(d, exist_ok=True)
            io.write_color(os.path.join(d, "000000.png"), io.resize_image(colors[i].numpy(), size), bit_depth=16)
    os.makedirs(os.path.join(root, "rigs"), exist_ok=True)
    tcam.save_rig(os.path.join(root, "rigs/rig_calibrated.json"), rig)
    return rig, levels


@pytest.fixture
def pools(monkeypatch):
    """Every pool an estimator builds during the test."""
    built = []

    class Recorded(pipeline.concurrent.futures.ThreadPoolExecutor):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    monkeypatch.setattr(pipeline.concurrent.futures, "ThreadPoolExecutor", Recorded)
    return built


def _shut_down(pool):
    return pool._shutdown and not any(t.is_alive() for t in pool._threads)


def test_derp_cli_pyramid_same_pfms_with_one_thread_and_eight(tmp_path, monkeypatch, pools):
    root = str(tmp_path / "in")
    rig, levels = _pyramid(root)
    argv = ["--input_root", root, "--min_depth_m", "1", "--max_depth_m", "100", "--resolution", "24"]
    outs = {}
    for cores in (1, 8):
        monkeypatch.setattr(os, "sched_getaffinity", lambda pid, n=cores: set(range(n)))
        outs[cores] = str(tmp_path / f"out{cores}")
        est = derp_cli.main(argv + ["--output_root", outs[cores]], device="cpu")
        # one pool a run, of as many threads as the process has cores, shut down when the run ended
        assert est.io_workers == cores and est._pool is None and len(pools) == 1 and _shut_down(pools[0])
        assert pools.pop()._max_workers == cores
        # 4 colors read and 4 PFMs written a level, and 4 coarser PFMs read below the coarsest
        assert {lv: est.spans.counts[(FRAME, lv)]["derp.pool.files"] for lv in levels} == {1: 8, 0: 12}
    for level in levels:
        for cam_id in rig.ids:
            a, b = (open(imagetypes.gen_filename(outs[n], "disparity_levels", level, cam_id, FRAME, "pfm"), "rb").read()
                    for n in (1, 8))
            assert a == b, (level, cam_id)


def test_the_pool_is_shut_down_when_a_run_fails(tmp_path, pools):
    root = str(tmp_path / "in")
    rig, _ = _pyramid(root)
    _break(io.frame_path(imagetypes.image_dir(root, "color_levels", 0, rig.ids[1]), FRAME), "corrupt")
    est = _estimator(root, str(tmp_path / "out"), min_depth_m=1.0, max_depth_m=100.0, resolution=24)
    with pytest.raises(zlib.error):
        est.run()
    assert est._pool is None and len(pools) == 1 and _shut_down(pools[0])
    # the coarser level was solved and written before the failure
    assert os.path.exists(imagetypes.gen_filename(str(tmp_path / "out"), "disparity_levels", 1, rig.ids[1], FRAME,
                                                  "pfm"))


def _png_cases():
    """test_torch_png.py's PNG kinds: (id, bytes)."""
    cases = []
    for ftype in range(5):
        for dtype in (np.uint8, np.uint16):
            for c in (1, 2, 3, 4):
                img = _image(dtype, c, seed=10 * ftype + c)
                cases.append((f"filter{ftype}-{np.dtype(dtype).name}-c{c}", lambda img=img, f=ftype: _png_bytes(
                    img, [f] * img.shape[0])))
    for interlace in (0, 1):
        for depth in (1, 2, 4, 8):
            for with_trns in (False, True):
                def palette(depth=depth, with_trns=with_trns, interlace=interlace):
                    rng = np.random.RandomState(depth + 10 * interlace)
                    entries = min(1 << depth, 40)
                    plte = rng.randint(0, 256, (entries, 3))
                    idx = rng.randint(0, entries, (9, 13, 1))
                    trns = bytes([0, 128, 255][:entries]) if with_trns else None
                    return _build_png(idx, depth, 3, interlace, plte.reshape(-1), trns, seed=depth)
                cases.append((f"palette{depth}-trns{int(with_trns)}-i{interlace}", palette))
        for depth in (1, 2, 4):
            cases.append((f"gray{depth}-i{interlace}", lambda depth=depth, interlace=interlace: _build_png(
                np.random.RandomState(depth).randint(0, 1 << depth, (11, 21, 1)), depth, 0, interlace, seed=depth)))
    for depth in (8, 16):
        for ctype in (0, 2, 4, 6):
            for hw in ((1, 1), (3, 5), (9, 9), (33, 17)):
                cases.append((f"adam7-{depth}-ct{ctype}-{hw[0]}x{hw[1]}", lambda d=depth, t=ctype, hw=hw: _build_png(
                    np.random.RandomState(hw[0] + t).randint(0, 1 << d, hw + (png._CHANNELS[t],)), d, t, 1, seed=t)))
        for ctype in (0, 2):
            def key(depth=depth, ctype=ctype):
                samples = np.random.RandomState(depth + ctype).randint(0, 3, (6, 7, png._CHANNELS[ctype]))
                trns = struct.pack(">HHH", 1, 2, 0) if ctype == 2 else struct.pack(">H", 2)
                return _build_png(samples, depth, ctype, trns=trns, seed=depth)
            cases.append((f"trns-key-{depth}-ct{ctype}", key))
    return cases


_PNG_CASES = dict(_png_cases())


def _written_by(library, tmp_path, dtype, channels):
    img = _image(dtype, channels, seed=channels, h=37, w=53)
    p = str(tmp_path / "w.png")
    if library == "cv2":
        import cv2

        cv2.imwrite(p, _bgr(img), [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS])
    else:
        from PIL import Image

        Image.fromarray(img[..., 0] if channels == 1 else img).save(p)
    return open(p, "rb").read()


def _decode_with_and_without_the_hint(data, monkeypatch):
    """(decode, hints given, inflated sizes) and the old decode (no hint) of ``data``."""
    hints, sizes = [], []

    def spy(stream, wbits=15, bufsize=None):
        out = zlib.decompress(stream, wbits) if bufsize is None else zlib.decompress(stream, wbits, bufsize)
        hints.append(bufsize)
        sizes.append(len(out))
        return out

    monkeypatch.setattr(png, "zlib", types.SimpleNamespace(decompress=spy, crc32=zlib.crc32, compress=zlib.compress))
    got = png.decode(data)
    monkeypatch.setattr(png, "zlib", types.SimpleNamespace(decompress=lambda stream, *a: zlib.decompress(stream),
                                                           crc32=zlib.crc32, compress=zlib.compress))
    old = png.decode(data)
    monkeypatch.undo()
    return got, old, hints, sizes


@pytest.mark.parametrize("case", sorted(_PNG_CASES))
def test_png_decode_size_hint_is_exact_and_changes_nothing(case, monkeypatch):
    got, old, hints, sizes = _decode_with_and_without_the_hint(_PNG_CASES[case](), monkeypatch)
    _same(got, old)
    assert hints == sizes and len(hints) == 1


# what each library writes: cv2 gray, BGR and BGRA at 8 and 16 bits (every filter type, chosen a row);
# PIL L, LA, RGB, RGBA and I;16 (adaptive filtering)
@pytest.mark.parametrize("library,dtype,channels",
                         [("cv2", d, c) for d in (np.uint8, np.uint16) for c in (1, 3, 4)]
                         + [("PIL", np.uint8, c) for c in (1, 2, 3, 4)] + [("PIL", np.uint16, 1)])
def test_png_decode_size_hint_on_library_written_files(tmp_path, monkeypatch, library, dtype, channels):
    got, old, hints, sizes = _decode_with_and_without_the_hint(
        _written_by(library, tmp_path, dtype, channels), monkeypatch)
    _same(got, old)
    assert hints == sizes


def test_png_decode_size_hint_is_bounded_where_a_header_claims_too_much():
    """A header claiming a 65535 x 65535 RGBA16 image over a tiny stream:
    the hint stays near the stream's size and the decode fails as before."""
    good = png.encode(np.zeros((2, 2, 4), np.uint16))
    chunks = list(png._chunks(good))
    ihdr = bytearray(chunks[0][1])
    ihdr[0:8] = (65535).to_bytes(4, "big") * 2
    data = (png._SIGNATURE + png._chunk(b"IHDR", bytes(ihdr)) + png._chunk(b"IDAT", chunks[1][1])
            + png._chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="truncated"):
        png.decode(data)
