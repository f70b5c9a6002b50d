"""Multi-GPU depth estimation on ``torch.distributed``: the port of the JAX
package's ``parallel/``.

- :mod:`.multihost` joins a process to a process group behind
  ``--coordinator_address`` (derp_cli's flags) and names the rank's card.
- :mod:`.sharding` solves a level with its destination cameras sharded over
  the ranks of a ``("cam",)`` mesh, or frames over a ``("frame", "cam")``
  mesh, through :func:`..depth.solver.process_level`; the one exchange is
  an all-gather of the disparity maps before the mismatch stage.
"""
