"""Scale runtime of the port: failure injection, elastic population
planning and the straggler policy (numpy and time; ``repro.runtime``'s
re-mesh and gradient compression are not ported yet)."""
from repro_torch.runtime.elastic import drop_shard, elastic_population_plan
from repro_torch.runtime.failure import (
    FailureInjector, FaultPlan, PoisonError, SimulatedFailure)
from repro_torch.runtime.straggler import StragglerPolicy

__all__ = ["FailureInjector", "FaultPlan", "PoisonError", "SimulatedFailure",
           "StragglerPolicy", "drop_shard", "elastic_population_plan"]
