"""The software ISP: the port of ``facebook360_dep_tpu/isp``.

``pipeline`` turns a RAW Bayer mosaic into RGB on the mosaic's device
(companding, black level, vignetting, white balance, stuck pixels, the four
demosaics, color correction, tone curve, sharpening); ``core/rawio.py``
reads and writes the ``.raw`` and ``.dng`` containers on the host.
"""
