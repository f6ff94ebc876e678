"""clrs_tpu_torch — the clustered low-rank SDP solver on PyTorch and CUDA.

A port of the JAX package ``clrs_tpu`` (the reference, which stays in the
repository beside it): a primal-dual XZ predictor-corrector interior-point
method for clustered low-rank SDPs in k-limb float-expansion arithmetic
(k = 2..12: double-double and up), with float64 limbs on every device.  Its hot kernels are written by hand for
NVIDIA Hopper (``csrc/``, built with nvcc at first use on the card); each
has a plain PyTorch version that runs on the CPU.

Layers (bottom-up):
  ops/     k-limb arithmetic, linear algebra, the CUDA kernels, the
           int8-sliced matmul (mxu_matmul.py, torch._int_mm)
  core/    block metadata, batching, problem packing, the IPM solver
           (the phase driver, and the device-resident loop that reads the
           device once per chunk of iterations), precision escalation (a
           ladder of limb counts, warm-started)
  models/  problem front-end: polynomial bases, sample points, prepareabc,
           solvempmp (polynomial matrix programs)
  apps/    applications (the Delsarte LP bound, N-species sphere packing,
           polynomial minimization on the simplex) and SDPB-format export
           and import
  utils/   checkpoints of the iterate, the mpmath oracle IPM, the flop
           and bound model
  parallel/ the cluster-sharded solve over the ranks of a
           torch.distributed process group, one device each, and the
           split of one large cluster's work inside it (intra.py: the
           pairing products, the Schur rows and the panel forms'
           trailing updates in row bands, ops/bands.py)

The entry points (``solverank1sdp``, ``solve_with_escalation``,
``solve_on_device`` (on its problem's own device),
``solvempmp``, ``delsarte_lp_bound``, ``nsphere_packing_2point``,
``polymin_simplex``, ``solve_sdpb``, ``load_state``) run on the CUDA card
unless given ``device="cpu"``.  Importing the package loads neither jax nor
clrs_tpu and sets no environment variable.
"""

from clrs_tpu_torch.apps.delsarte import delsarte_lp_bound
from clrs_tpu_torch.apps.polymin import polymin_simplex
from clrs_tpu_torch.apps.sdpb_export import write_sdpb_files
from clrs_tpu_torch.apps.sdpb_import import read_sdpb_dir, solve_sdpb
from clrs_tpu_torch.apps.sphere_packing import nsphere_packing_2point
from clrs_tpu_torch.core.blockinfo import BlockInfo, get_block_info
from clrs_tpu_torch.core.device_loop import solve_on_device
from clrs_tpu_torch.core.escalate import solve_with_escalation
from clrs_tpu_torch.core.solver import SolverConfig, make_fused_step, solverank1sdp
from clrs_tpu_torch.models.mpmp import solvempmp
from clrs_tpu_torch.models.prepare import prepareabc
from clrs_tpu_torch.ops.xfloat import XF
from clrs_tpu_torch.parallel.hetero import solve_hetero_sharded
from clrs_tpu_torch.parallel.multihost import solve_hetero_multihost
from clrs_tpu_torch.utils.checkpoint import load_state, save_state

__all__ = [
    "XF",
    "BlockInfo",
    "SolverConfig",
    "solverank1sdp",
    "make_fused_step",
    "solve_on_device",
    "solve_with_escalation",
    "solvempmp",
    "get_block_info",
    "prepareabc",
    "delsarte_lp_bound",
    "nsphere_packing_2point",
    "polymin_simplex",
    "read_sdpb_dir",
    "solve_sdpb",
    "write_sdpb_files",
    "save_state",
    "load_state",
    "solve_hetero_sharded",
    "solve_hetero_multihost",
]
