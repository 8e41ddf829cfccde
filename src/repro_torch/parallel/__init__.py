"""Parallel execution subsystem of the port.

* ``cluster``     — the paper's §5.3–5.5 multi-core cluster on one device:
  streamed iteration spaces split C ways on their outer loop level
  (``cluster_call`` / ``cluster_chain_call`` / ``cluster_kernel``), each
  core one shard run through the single-core path, with a single
  fixed-order sum standing in for the shared-TCDM combine.
* ``activations`` — the model stack's activation-sharding constraints:
  the identity on one device (a mesh is port slice 9d).
* ``sharding``, ``collectives`` — the model stack's policies and ring
  matmuls: port slice 9d.

Import submodules explicitly (``from repro_torch.parallel import
cluster``); this package root stays import-free.
"""
