"""Failure detection and elastic remeshing (the counterpart of
``repro.runtime``)."""
from .failures import (FailureDetector, RemeshPlan, StragglerPolicy, plan_elastic_remesh,
                       surviving_subgraph)

__all__ = ["FailureDetector", "RemeshPlan", "StragglerPolicy", "plan_elastic_remesh",
           "surviving_subgraph"]
