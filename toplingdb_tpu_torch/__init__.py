"""toplingdb_tpu_torch: the PyTorch + CUDA port of toplingdb_tpu.

The port runs the device compaction data plane on an NVIDIA Hopper card:
input SSTs are scanned on the host, each key-range shard's merge, MVCC GC
and survivor compaction run on the card (two hand-written CUDA kernels plus
PyTorch ops), and the output SSTs are byte-identical to the ones
toplingdb_tpu writes for the same job, in every table format (block,
single_fast, cuckoo, plain, zip) and with every table option,
compressed or not. Entry points:
`toplingdb_tpu_torch.ops.device_compaction.run_device_compaction`, and the
dcompact worker that runs one serialized job from a job dir,
`python -m toplingdb_tpu_torch.compaction.worker --job-dir DIR`.

The package never imports jax or toplingdb_tpu; the host modules it needs
are its own copies, at the same paths as their counterparts.
"""
