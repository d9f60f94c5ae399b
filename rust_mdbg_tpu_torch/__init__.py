"""rust_mdbg_tpu_torch — the PyTorch/CUDA port of the mdBG assembler.

It sits beside `rust_mdbg_tpu` (the JAX reference) and mirrors its layout:
`ops/` (device compute), `core/` (drivers, node table, GFA), `io/`, `native/`
(C++ host libraries) and `utils/`.  It imports torch and never jax, and
nothing of `rust_mdbg_tpu`: host-side modules are kept as copies.

u64 values live in int64 tensors as bit patterns (`ops/u64.py`).  The one
hand-written Hopper kernel (`csrc/nthash_select.cu`) replaces the Pallas
kernel `nthash_select_pallas`; it is built with nvcc on first use.

Entry points take a `device` argument and run on "cuda" unless the caller
passes "cpu"; with no GPU and no explicit "cpu" they raise.
"""

from .params import Params, autodetect_k_l_d  # noqa: F401

__version__ = "0.1.0"
