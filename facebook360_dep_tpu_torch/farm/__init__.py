"""The render farm: the port of ``facebook360_dep_tpu/farm``, host code only.

``runner`` runs stages over frame chunks with missing-chunk resume (locally
or as the master of a ``broker`` queue that ``worker`` processes drain),
``transfer`` moves trees between local paths and object stores, and
``cluster`` provisions and retires a fleet of single-H100 VMs.
"""
