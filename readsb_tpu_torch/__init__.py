"""PyTorch + CUDA port of the readsb_tpu demodulator.

Native code (the host finalizer and the CUDA kernels) is compiled at
first use into BUILD_DIR: `$READSB_TPU_TORCH_BUILD_DIR` where that is set
and not empty, else `build/readsb_tpu_torch/` beside the package, which
`.gitignore` lists.  The variable is the port's counterpart of
readsb_tpu's READSB_TPU_JAX_CACHE (`utils/jaxcache.py`): where compiled
artefacts live.  An install whose package directory is read-only (a
systemd unit under ProtectSystem=, a container) points it at a writable
directory.  An unwritable BUILD_DIR raises where a library is built.
"""

import os

BUILD_DIR = os.environ.get("READSB_TPU_TORCH_BUILD_DIR") or os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "build", "readsb_tpu_torch",
)
