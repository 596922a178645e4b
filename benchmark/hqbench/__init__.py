"""The benchmark harness of `hqtransformer_tpu_torch`: the manifest and
the files it names, seeded weights, the operation and byte counts, spans,
the device trace, and the comparisons that decide `correct`.

Nothing here imports JAX or the JAX package; the program under test is
imported only by the drivers (`benchmark/drivers/`) and `weights`.
"""
