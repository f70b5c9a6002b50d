"""Data-plane transfers: the network.py equivalent.

Reference: ``scripts/render/network.py:41-790`` — an ``Address`` abstraction
over s3://, smb://, and POSIX paths, with frame download/upload via
``aws s3 sync``/copy and tar-frame packing to cut request counts. The
fleet (farm.cluster) talks to GCS (gs://); S3 URIs remain supported for
data migration. Remote operations shell out to gsutil/aws CLIs; local paths copy
directly. Everything is testable offline via ``dry_run``.
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess
import tarfile
from dataclasses import dataclass

log = logging.getLogger("transfer")


@dataclass(frozen=True)
class Address:
    """Parsed transfer endpoint (network.py:41-75)."""

    protocol: str  # "gs", "s3", "smb", or "" (local)
    path: str

    @classmethod
    def parse(cls, uri: str) -> "Address":
        for proto in ("gs", "s3", "smb"):
            prefix = proto + "://"
            if uri.startswith(prefix):
                return cls(proto, uri[len(prefix):])
        return cls("", uri)

    @property
    def is_remote(self) -> bool:
        return self.protocol != ""

    def join(self, *parts: str) -> "Address":
        return Address(self.protocol, "/".join([self.path.rstrip("/"), *parts]))

    def uri(self) -> str:
        return f"{self.protocol}://{self.path}" if self.is_remote else self.path


def _cloud_cmd(src: Address, dst: Address, sync: bool) -> list[str]:
    if "gs" in (src.protocol, dst.protocol):
        return ["gsutil", "-m", "rsync", "-r"] + [src.uri(), dst.uri()] if sync else [
            "gsutil", "-m", "cp", "-r", src.uri(), dst.uri()
        ]
    if "s3" in (src.protocol, dst.protocol):
        verb = "sync" if sync else "cp"
        extra = [] if sync else ["--recursive"]
        return ["aws", "s3", verb, src.uri(), dst.uri(), *extra]
    raise ValueError(f"no transfer tool for {src.protocol}/{dst.protocol}")


def transfer(src: str, dst: str, sync: bool = True, dry_run: bool = False) -> list[str] | None:
    """Copy/sync a tree between any two endpoints. Returns the command used
    for remote transfers (None for local copies)."""
    a, b = Address.parse(src), Address.parse(dst)
    if not a.is_remote and not b.is_remote:
        if dry_run:
            return ["cp", "-r", a.path, b.path]
        if os.path.isdir(a.path):
            shutil.copytree(a.path, b.path, dirs_exist_ok=True)
        else:
            os.makedirs(os.path.dirname(os.path.abspath(b.path)), exist_ok=True)
            shutil.copy2(a.path, b.path)
        return None
    cmd = _cloud_cmd(a, b, sync)
    if dry_run:
        return cmd
    log.info("%s", " ".join(cmd))
    subprocess.run(cmd, check=True)
    return cmd


def pack_frame_tar(root: str, frame: str, out_path: str, image_types: list[str]) -> str:
    """Bundle one frame's files across image types into a tar
    (scripts/util/tar_frame.py — fewer object-store requests per frame)."""
    from ..core import imagetypes

    with tarfile.open(out_path, "w") as tar:
        for t in image_types:
            base = imagetypes.image_dir(root, t)
            if not os.path.isdir(base):
                continue
            for cam_id in sorted(os.listdir(base)):
                cam_dir = os.path.join(base, cam_id)
                if not os.path.isdir(cam_dir):
                    continue
                for f in sorted(os.listdir(cam_dir)):
                    if os.path.splitext(f)[0] == frame:
                        full = os.path.join(cam_dir, f)
                        tar.add(full, arcname=os.path.relpath(full, root))
    return out_path


def unpack_frame_tar(tar_path: str, root: str) -> list[str]:
    with tarfile.open(tar_path) as tar:
        names = tar.getnames()
        tar.extractall(root, filter="data")
    return names
