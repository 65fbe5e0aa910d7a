"""Parallel execution of the port (counterpart of ``proxtpu.parallel``):
the batched drivers (plain, recorded, segmented, compacting),
``BatchedAlgorithm``, the flat trial/commit machines
of the line-search and adaptive solvers, the float32 -> float64 warm start,
pipelined dispatch, and the sharding layer on ``torch.distributed``
(process groups and meshes, sharded operators, consensus ADMM over
rank-held blocks, the batched kernel solvers on each rank's own lanes)."""

from ..utils.shared import Shared, batch_axes, unwrap_shared
from .adaptive_batch import batched_adaptive_fb, batched_adaptive_fista
from .batch import (
    BatchedAlgorithm,
    batch_problems,
    batched_run_loop,
    batched_run_recorded,
    batched_run_segments,
    broadcast_hyperparams,
    compacting_batched_run,
    stack_iterations,
)
from .flat_ls import (
    batched_drls,
    batched_panoc,
    batched_panocplus,
    batched_zerofpr,
)
from .consensus import (
    ConsensusADMM,
    ConsensusADMMIteration,
    make_consensus_admm_iteration,
    stack_functions,
)
from .distributed import global_mesh, initialize_distributed
from .sharded_kernels import (
    default_dp_mesh,
    sharded_solve_box_qp_batch,
    sharded_solve_lasso_batch,
    sharded_solve_lasso_batch_blocked,
    sharded_solve_lasso_batch_packed,
    sharded_solve_lasso_multirhs,
    sharded_solve_tv_batch,
)
from .sharded_ops import (
    ShardedMatrixOperator,
    make_mesh,
    replicate,
    shard_batch,
    shard_matrix_operator,
)
from .stream import stream_solve
from .warm import (
    WarmStartedAlgorithm,
    WarmStartedBatchedAlgorithm,
    cast_problem,
)

__all__ = [
    "BatchedAlgorithm",
    "WarmStartedAlgorithm",
    "WarmStartedBatchedAlgorithm",
    "cast_problem",
    "Shared",
    "batch_axes",
    "unwrap_shared",
    "batched_adaptive_fb",
    "batched_adaptive_fista",
    "batched_drls",
    "batched_panoc",
    "batched_panocplus",
    "batched_zerofpr",
    "batch_problems",
    "batched_run_loop",
    "batched_run_recorded",
    "batched_run_segments",
    "broadcast_hyperparams",
    "compacting_batched_run",
    "stack_iterations",
    "ConsensusADMM",
    "ConsensusADMMIteration",
    "make_consensus_admm_iteration",
    "stack_functions",
    "ShardedMatrixOperator",
    "make_mesh",
    "replicate",
    "shard_batch",
    "shard_matrix_operator",
    "global_mesh",
    "initialize_distributed",
    "default_dp_mesh",
    "sharded_solve_box_qp_batch",
    "sharded_solve_lasso_batch",
    "sharded_solve_lasso_batch_packed",
    "sharded_solve_lasso_batch_blocked",
    "sharded_solve_lasso_multirhs",
    "sharded_solve_tv_batch",
    "stream_solve",
]
