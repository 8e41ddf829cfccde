"""Parallel execution subsystem of the port.

* ``cluster``     — the paper's §5.3–5.5 multi-core cluster on one device:
  streamed iteration spaces split C ways on their outer loop level
  (``cluster_call`` / ``cluster_chain_call`` / ``cluster_kernel``), each
  core one shard run through the single-core path, with a single
  fixed-order sum standing in for the shared-TCDM combine.
* ``activations`` — the ambient mesh (``activation_mesh``) and the
  reference's activation-sharding constraints, the identity in explicit
  SPMD;
* ``sharding`` — the sharding policy (the reference's spec trees) and
  placing leaves as a rank's shards (``shard_tree`` / ``gather_tree``);
* ``collectives`` — collectives over a mesh's axes (gloo stages a CUDA
  tensor through the host), their adjoints, and the ring matmuls.

Import submodules explicitly (``from repro_torch.parallel import
cluster``); this package root stays import-free.
"""
