"""GlViewer equivalent: interactive 6DoF playback of fused streaming output.
The port of ``facebook360_dep_tpu/cli/gl_viewer.py``.

Flags mirror the reference binary (viewer/GlViewer.cpp:42-45). The GL
runtime is the browser: this serves http://127.0.0.1:<port>/ with a WebGL2
implementation of RigScene's displaced-mesh accumulate/resolve pipeline (see
viewer/server.py). The server is host math and IO by design: it takes no
device and never touches the card.

    python -m facebook360_dep_tpu_torch.cli.gl_viewer --rig <rig.json> --catalog <fused>/fused.json --port 8666
"""

from __future__ import annotations

import argparse
import logging
import os


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--catalog", required=True, help="fused.json catalog path")
    p.add_argument("--strip_files", default="", help="comma-separated stripe files (default: catalog dir)")
    p.add_argument("--disks", default="", help=(
        "alias of --strip_files (the canonical res/flags/gl_viewer.flags "
        "uses --disks; the reference binary itself defines --strip_files, "
        "GlViewer.cpp:43)"))
    p.add_argument("--readahead", type=int, default=3, help="frames to read ahead (GlViewer.cpp:44)")
    p.add_argument("--rig", required=True, help="path to rig .json")
    p.add_argument("--port", type=int, default=8666)
    args = p.parse_args(argv)

    fused_dir = os.path.dirname(os.path.abspath(args.catalog))
    strip_files = args.strip_files or args.disks
    num_disks = len([s for s in strip_files.split(",") if s]) or 1
    from ..viewer import server

    httpd = server.serve(args.rig, fused_dir, num_disks, args.port, args.readahead)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        httpd.shutdown()
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
