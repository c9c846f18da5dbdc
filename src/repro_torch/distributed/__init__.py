"""Sharded mining on a single-controller mesh of shards.

One process drives every shard, as the JAX package's ``shard_map`` does:
a :class:`~repro_torch.distributed.mesh.Mesh` is an explicit list of
devices, one per shard, and the collectives (``psum``, the halo shift,
``all_gather``, ``all_to_all``, ``pmax``) are tensor operations over the
per-shard list.  On a card, shard *i* sits on ``cuda:(i % device_count)``;
on the CPU every shard is ``"cpu"``.

* ``dfg`` / ``discovery`` — the halo-carry drivers: one kernel update a
  shard, the previous shard's tail rows as its carry, one ``psum``;
* ``variants`` — affine hash maps folded across shards by an
  ``all_gather`` of each shard's whole-shard map;
* ``query`` — the pruned stream gathered on the host and cut into shards
  (the ``Dataset``'s ``engine="sharded"``), and the merge-tree sharding of
  every other stitchable verb;
* ``sort`` — the bucket exchange (``all_to_all``) + local lexsort.
"""
