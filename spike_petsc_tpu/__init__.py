"""spike_petsc_tpu — a SPIKE banded linear-solver framework for CUDA GPUs.

Built from scratch in JAX/Pallas with the capabilities of spikegpu/spike-petsc
(reference analysed in SURVEY.md): reordering/scaling pipeline (MC64 WBM,
AWBM, Fiedler, RCM, spectral partitioning), norm-fraction banded extraction,
composable KSP/PC solver layer, the SPIKE partitioned banded kernel itself,
and multi-device execution over `jax.sharding` meshes whose collectives
replace the reference's PETSc/MPI communication.
"""

__version__ = "0.1.0"

from .ops.band import (BandedMatrix, banded_from_dense, banded_from_coo,
                       banded_to_dense, banded_matvec, banded_diagonal,
                       banded_shift, banded_scale, banded_axpy,
                       banded_diagonal_scale)
from .ops.blocktri import (BlockTridiagonal, band_to_blocktri,
                           blocktri_factor, blocktri_solve,
                           blocktri_solve_transpose, blocktri_matvec)
from .ops.spike import (SpikeFactor, spike_factor, spike_factor_grouped,
                        spike_solve, spike_solve_many, spike_transpose)
from .ops.autodiff import solve_banded_diff
from .solvers.ksp import (solve, solve_many, make_solver,
                          make_solver_many)
from .solvers.pc import PC, make_pc
from .solvers.types import KSPResult, reason_str
from .utils.options import Options
from .utils.registry import (ORDERINGS, PRECONDITIONERS, SOLVERS,
                             register_ksp, register_ordering, register_pc)
from . import sparse

__all__ = [
    "BandedMatrix", "banded_from_dense", "banded_from_coo", "banded_to_dense",
    "banded_matvec", "banded_diagonal", "banded_shift",
    "banded_scale", "banded_axpy", "banded_diagonal_scale",
    "BlockTridiagonal", "band_to_blocktri", "blocktri_factor",
    "blocktri_solve", "blocktri_solve_transpose", "blocktri_matvec",
    "SpikeFactor", "spike_factor", "spike_factor_grouped", "spike_solve",
    "spike_solve_many", "spike_transpose",
    "solve_banded_diff",
    "solve", "solve_many", "make_solver", "make_solver_many",
    "PC", "make_pc",
    "KSPResult", "reason_str",
    "Options", "ORDERINGS", "PRECONDITIONERS", "SOLVERS",
    "register_ksp", "register_ordering", "register_pc", "sparse",
]
