"""The benchmark's tests run from the root of the checkout:

    python -m pytest bpebench/tests -q

They run on the CPU, on the plain versions of the program's kernels and at
sizes a test run holds; nothing here times anything."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

# the tests run in several workers at once; one thread each keeps them
# from crowding the cores
torch.set_num_threads(1)
