"""PyTorch + CUDA port of the readsb_tpu demodulator.

Native code (the host finalizer and the CUDA kernels) is compiled at
first use into BUILD_DIR, which `.gitignore` lists.
"""

import os

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "build", "readsb_tpu_torch",
)
