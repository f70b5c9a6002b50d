"""Striped binary fusion for 6DoF streaming playback: the port of
``facebook360_dep_tpu/stream/fusion.py``, byte for byte.

Reference: ``mesh_stream/StripedFile.h:21-120`` (512 KiB stripes round-robin
across N "disk" files) and ``mesh_stream/BinaryFusionUtil.h:26-120``
(per-frame/camera .vtx/.idx/.bc7 packing with 0x5A padding to stripe
alignment + fused.json catalog). Byte-compatible so the reference GlViewer
can stream our output.
"""

from __future__ import annotations

import json
import os

STRIPE_SIZE = 512 * 1024  # StripedFile.h:22
PAD_BYTE = 0x5A


def calc_stripe(global_offset: int, disk_count: int) -> tuple[int, int]:
    """global offset -> (local offset within disk, disk index). StripedFile.h:100-104."""
    stripe = global_offset // STRIPE_SIZE
    local = (stripe // disk_count) * STRIPE_SIZE + global_offset % STRIPE_SIZE
    return local, stripe % disk_count


def _align(offset: int, alignment: int) -> int:
    return (offset + alignment - 1) // alignment * alignment


class StripedWriter:
    """Sequential writer across N stripe files (fusion is append-only)."""

    def __init__(self, paths):
        self.files = [open(p, "wb") for p in paths]
        self.offset = 0

    def write(self, data: bytes) -> None:
        view = memoryview(data)
        while len(view):
            disk = (self.offset // STRIPE_SIZE) % len(self.files)
            room = STRIPE_SIZE - self.offset % STRIPE_SIZE
            chunk = view[: min(room, len(view))]
            self.files[disk].write(chunk)
            self.offset += len(chunk)
            view = view[len(chunk) :]

    def pad_to_stripe(self) -> None:
        aligned = _align(self.offset, STRIPE_SIZE)
        if aligned != self.offset:
            self.write(bytes([PAD_BYTE]) * (aligned - self.offset))

    def close(self) -> None:
        for f in self.files:
            f.close()


class StripedReader:
    """Random-access reads over the stripe files (AsyncFile/StripedFile read
    path; synchronous here — playback readahead lives in the viewer layer)."""

    def __init__(self, paths):
        self.files = [open(p, "rb") for p in paths]

    def read(self, offset: int, size: int) -> bytes:
        out = bytearray()
        while size > 0:
            local, disk = calc_stripe(offset, len(self.files))
            room = STRIPE_SIZE - offset % STRIPE_SIZE
            n = min(room, size)
            self.files[disk].seek(local)
            out += self.files[disk].read(n)
            offset += n
            size -= n
        return bytes(out)

    def close(self) -> None:
        for f in self.files:
            f.close()


def fuse_frames(
    bin_dir: str,
    fused_dir: str,
    rig_ids,
    frames,
    extensions=(".vtx", ".idx", ".bc7"),
    num_disks: int = 1,
) -> dict:
    """Pack per-frame/camera binary files into stripe files + fused.json.

    BinaryFusionUtil.h:59-85 fuseFrame + ConvertToBinary.cpp:281-301.
    """
    os.makedirs(fused_dir, exist_ok=True)
    paths = [os.path.join(fused_dir, f"fused_{i}.bin") for i in range(num_disks)]
    writer = StripedWriter(paths)
    catalog = {
        "metadata": {"isLittleEndian": True},
        "frames": {},
    }
    try:
        for frame in frames:
            frame_entry = catalog["frames"][frame] = {}
            for cam_id in rig_ids:
                begin = writer.offset
                cam_entry = frame_entry[cam_id] = {}
                for ext in extensions:
                    ext_begin = writer.offset
                    path = os.path.join(bin_dir, cam_id, frame + ext)
                    with open(path, "rb") as f:
                        writer.write(f.read())
                    cam_entry[ext] = {"offset": ext_begin, "size": writer.offset - ext_begin}
                cam_entry["offset"] = begin
                cam_entry["size"] = writer.offset - begin
                # optional ConvertToBinary sidecar: true color texture dims
                # (normalized rigs cannot provide them via camera aspect)
                meta_path = os.path.join(bin_dir, cam_id, frame + ".meta.json")
                if os.path.exists(meta_path):
                    with open(meta_path) as mf:
                        meta = json.load(mf)
                    if "color_wh" in meta:
                        cam_entry["color_wh"] = meta["color_wh"]
                writer.pad_to_stripe()
    finally:
        writer.close()
    with open(os.path.join(fused_dir, "fused.json"), "w") as f:
        json.dump(catalog, f, indent=2, sort_keys=True)
    return catalog


def read_fused_entry(fused_dir: str, catalog: dict, frame: str, cam_id: str, ext: str, num_disks: int = 1) -> bytes:
    paths = [os.path.join(fused_dir, f"fused_{i}.bin") for i in range(num_disks)]
    reader = StripedReader(paths)
    entry = catalog["frames"][frame][cam_id][ext]
    try:
        return reader.read(entry["offset"], entry["size"])
    finally:
        reader.close()
