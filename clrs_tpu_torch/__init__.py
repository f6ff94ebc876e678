"""clrs_tpu_torch — the clustered low-rank SDP solver on PyTorch and CUDA.

A port of the JAX package ``clrs_tpu`` (the reference, which stays in the
repository beside it): a primal-dual XZ predictor-corrector interior-point
method for clustered low-rank SDPs in k-limb float-expansion arithmetic
(k = 2..12: double-double and up), with float64 limbs on every device.  Its hot kernels are written by hand for
NVIDIA Hopper (``csrc/``, built with nvcc at first use on the card); each
has a plain PyTorch version that runs on the CPU.

Layers (bottom-up):
  ops/     k-limb arithmetic, linear algebra, the CUDA kernels
  core/    block metadata, batching, problem packing, the IPM solver
  models/  problem front-end: polynomial bases, sample points, prepareabc
  apps/    applications (the Delsarte LP bound)

The entry points (``solverank1sdp``, ``delsarte_lp_bound``) solve on the
CUDA card unless given ``device="cpu"``.  Importing the package loads
neither jax nor clrs_tpu and sets no environment variable.
"""

from clrs_tpu_torch.apps.delsarte import delsarte_lp_bound
from clrs_tpu_torch.core.blockinfo import BlockInfo, get_block_info
from clrs_tpu_torch.core.solver import SolverConfig, solverank1sdp
from clrs_tpu_torch.models.prepare import prepareabc
from clrs_tpu_torch.ops.xfloat import XF

__all__ = [
    "XF",
    "BlockInfo",
    "SolverConfig",
    "solverank1sdp",
    "get_block_info",
    "prepareabc",
    "delsarte_lp_bound",
]
