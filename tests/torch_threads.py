"""One torch thread in every pytest-xdist worker.

Under xdist several workers share the machine's cores, and each worker's
torch would start a thread pool as wide as the machine: the pools then
oversubscribe the cores and slow every worker, JAX's compiles included.
The port's test modules import this module for that side effect.  Every
worker collects, and so imports, every test module before it runs a test,
so each worker runs all its tests with one torch thread; a run in one
process keeps torch's default.  Measured with 6 workers on 8 cores (the
tier-1 command): the whole suite took 1433.7 s with one torch thread per
worker against 1649.8 s with torch's default pools, and the port's test
files alone in 4 workers 98.0 s against 167.1 s.
"""

import os

import torch

if "PYTEST_XDIST_WORKER" in os.environ:
    torch.set_num_threads(1)
