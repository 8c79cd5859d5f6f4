"""DGO core of the PyTorch port.

``__all__`` is the subset of ``repro.core.__all__`` that the port has so
far (``tests/test_torch_imports.py`` checks that it stays a subset).
"""
from repro_torch.core import cache, objectives
from repro_torch.core.dgo import DGOConfig, DGOResult, dgo_iteration
from repro_torch.core.distributed import (
    BatchedResult,
    make_distributed_engine,
    make_distributed_engine_batched,
    make_distributed_step,
)
from repro_torch.core.encoding import (
    Encoding, binary_to_gray, decode, encode, gray_to_binary)
from repro_torch.core.population import (
    generate_children, generate_population, population_size)
from repro_torch.core.solver import (
    Batched,
    Clustered,
    Distributed,
    Fused,
    NonFiniteResult,
    Problem,
    Sequential,
    SolveRequest,
    SolveResult,
    Strategy,
    engine_signature,
    resolve_mesh,
    result_is_finite,
    solve,
    solve_many,
    strategy_names,
)
from repro_torch.core.subspace import (
    apply_subspace, make_dgo_train_step, materialize_winner)

__all__ = [
    # the solver facade
    "Batched",
    "Clustered",
    "Distributed",
    "Fused",
    "NonFiniteResult",
    "Problem",
    "Sequential",
    "SolveRequest",
    "SolveResult",
    "Strategy",
    "engine_signature",
    "resolve_mesh",
    "result_is_finite",
    "solve",
    "solve_many",
    "strategy_names",
    # shared specs / subsystems
    "DGOConfig",
    "DGOResult",
    "BatchedResult",
    "Encoding",
    "cache",
    "objectives",
    # encoding / population primitives
    "binary_to_gray",
    "decode",
    "dgo_iteration",
    "encode",
    "generate_children",
    "generate_population",
    "gray_to_binary",
    "population_size",
    # engine builders
    "make_distributed_engine",
    "make_distributed_engine_batched",
    "make_distributed_step",
    # subspace DGO (LM training path)
    "apply_subspace",
    "make_dgo_train_step",
    "materialize_winner",
]
