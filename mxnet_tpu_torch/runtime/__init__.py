"""Runtime services (port of ``mxnet_tpu/runtime/``, subset: ``rng``)."""
