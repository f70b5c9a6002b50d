"""Rig calibration: the port of ``facebook360_dep_tpu/calib``.

``features`` detects corners and matches them between cameras (float32, on
the rig's device), ``ba`` triangulates and bundle-adjusts (float64, on the
rig's device), ``calibration`` runs the reference's multi-pass solve, and
``rig_tools`` aligns and compares rigs on the host. ``overlays`` draws the
``--debug_dir`` imagery with OpenCV.
"""
