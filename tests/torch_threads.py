"""Caps torch's CPU threads in a process that runs the port's tests.

Imported first by every ``tests/test_torch_*.py``.  Under ``pytest -n 6`` six
worker processes share the machine with the timing-bound tests of the JAX
package; torch's default of one intra-op thread per core in each worker
oversubscribes the cores several times over.  The port's tests run small
shapes, where more threads buy little.  The inter-op pool can only be sized
before a process first uses it, so that cap applies only where it is still
settable.
"""

import torch

#: Threads per test process, intra-op and (where still settable) inter-op.
TORCH_THREADS = 2

torch.set_num_threads(TORCH_THREADS)
try:
    torch.set_num_interop_threads(TORCH_THREADS)
except RuntimeError:  # this process has already run inter-op work
    pass
