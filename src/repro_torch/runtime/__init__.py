"""Scale runtime of the port: failure injection, elastic re-meshing and
population planning, the straggler policy, and int8 gradient
compression with error feedback."""
from repro_torch.runtime.compress import (
    compressed_psum, dequantize_int8, init_error_state,
    make_compressed_dp_grad_fn, quantize_int8)
from repro_torch.runtime.elastic import (
    drop_shard, elastic_population_plan, remesh, reshard_tree)
from repro_torch.runtime.failure import (
    FailureInjector, FaultPlan, PoisonError, SimulatedFailure)
from repro_torch.runtime.straggler import StragglerPolicy

__all__ = ["FailureInjector", "FaultPlan", "PoisonError", "SimulatedFailure",
           "StragglerPolicy", "compressed_psum", "dequantize_int8",
           "drop_shard", "elastic_population_plan", "init_error_state",
           "make_compressed_dp_grad_fn", "quantize_int8", "remesh",
           "reshard_tree"]
