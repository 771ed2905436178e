"""The port's bench: ``python -m mvtrim_tpu_torch.bench``.

The counterpart of the JAX package's ``bench.py`` and
``benchmarks/{word,sad,mv,feeder,dispatch_batch}_bench.py``, which stay
the JAX package's.  The families (``words``, ``grids``, ``mv``, ``sad``)
time the port's kernels on the card beside the controls of
``controls.py`` and their bounds, by the audit of ``audit.py``;
``feeder.py`` and ``dispatch_batch.py`` time the host's feeder and
dispatch around them (``python -m mvtrim_tpu_torch.bench.feeder``, ``...
.dispatch_batch``).  Importing a module of this package starts nothing.
"""
