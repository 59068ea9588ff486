"""Multi-device parallelism: the framework's two scale-out axes (the
counterpart of toplingdb_tpu/parallel/).

  'jobs'   one compaction job per device: the dcompact fan-out axis
           (RocksDB: one CompactionJob per worker process). Jobs are
           independent: no collectives on the hot path.
  'range'  key-range sharding WITHIN one job: the subcompaction axis
           (RocksDB's GenSubcompactionBoundaries), realized as a
           distributed sample sort: local sort → splitter all_gather →
           all_to_all redistribution → local merge → boundary halo → GC
           mask.

mesh_plan.py places one job's uniform shards over a list of devices (the
mesh route of ops/mesh_compaction.py); distributed_gc.py runs the 'range'
axis over torch.distributed process groups (gloo on the CPU, NCCL on
CUDA); scaling_probe.py measures both; entry.py holds `entry` and
`dryrun_multichip`.
"""
