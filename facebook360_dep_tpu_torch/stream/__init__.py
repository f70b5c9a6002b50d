"""The 6DoF publish and playback formats: the port of ``facebook360_dep_tpu/stream``.

- :mod:`.native`: the C++ host codecs of ``_native/`` (mesh faces, QEM
  simplify, BC7, mesh raster, EXR PIZ, PNG unfilter), built with g++ at
  first use;
- :mod:`.mesh`: equi-error vertex grids, torn faces, masks, .vtx/.idx/.obj;
- :mod:`.adaptive`: the tiled-LOD pre-decimation before QEM;
- :mod:`.fusion`: the striped fused stream and its catalog;
- :mod:`.async_loader`: read-ahead playback reads of the fused stream.

The submodules are imported where they are used: ``core.png`` needs
:mod:`.native` alone.
"""
