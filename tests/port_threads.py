"""Torch's intra-op threads for the port's CPU tests that run whole models.

Under pytest-xdist every worker process would otherwise start one OpenMP
thread per core, so the workers' threads together oversubscribe the host
many times over, and each parallel region waits for its slowest thread.
``share_cores`` gives each worker its share of the cores for the module's
tests, at least two, and restores torch's setting after them. (At one
thread, torch's CPU backward of the R50-FPN steps in
``test_torch_port_train_step.py`` strays from JAX's by ~5% of the largest
gradient on ``res4_block0.conv3``, beyond that file's trunk tolerance; at
two threads and at eight it stays within 0.25%. The cause is one ReLU gate
of ``res4_block0``: on that test's input one pre-ReLU sum lies within f32
rounding of zero (-8.26e-6 at one thread, +4.14e-6 at two, on a map whose
largest magnitude is 34.8), and the thread count, through the order in
which the convolution sums, decides its side; the gate then passes or
blocks an upstream gradient of ~29% of the largest reaching the block. The
port is right at every thread count.)"""
import os

import pytest
import torch

MIN_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def share_cores():
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(MIN_THREADS, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)
