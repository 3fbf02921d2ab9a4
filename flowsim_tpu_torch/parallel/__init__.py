"""Ensemble (scenario-batch) parallelism of the port.

Counterpart of ``flowsim_tpu/parallel``: so far :mod:`.ensemble` only.  The
device mesh, the sharded entry points and the domain decomposition wait for the
scale-out slice (ROADMAP.md Queue 1 item 13).
"""
