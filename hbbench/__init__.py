"""hbbench: the benchmark of the PyTorch/CUDA port, ``cleisthenes_tpu_torch``.

HoneyBadgerBFT epochs of ``LockstepCluster`` on one card, under the
traffic mixes of ``traffic/`` and the deployments of ``configs/``; the
cells are the ``workloads`` of ``BENCHMARK.json`` at the repository's
root.  ``run.py`` runs one cell once; ``control.py`` runs the planted
faults; ``reference/`` is the plain reference that decides ``correct``;
``yardstick.py`` and ``trace.py`` are the frozen roofline and device
split.  A configuration may name any group the port's ``"cuda"`` engine
hosts: the 256-bit kernels' (K7-K9) or a wide family's (K12, 257 to
2,112 bits).  Nothing here imports JAX or the JAX package.
"""
