"""Serving runtime of the port: requests, sampling, KV ledger, batching,
and the continuous-batching engine."""
from repro_torch.runtime.batching import (ADMISSIONS, AdmissionPolicy,
                                          BatchScheduler, FCFSAdmission,
                                          PrefillGroup, ShortestPromptFirst,
                                          StepPlan, TokenBudgetAdmission,
                                          make_admission)
from repro_torch.runtime.engine import EngineStats, ServingEngine
from repro_torch.runtime.kv import KVCacheManager, KVStats
from repro_torch.runtime.request import Request, RequestState
from repro_torch.runtime.sampler import sample

__all__ = ["EngineStats", "ServingEngine", "Request", "RequestState",
           "sample", "KVCacheManager", "KVStats", "BatchScheduler",
           "StepPlan", "PrefillGroup", "AdmissionPolicy", "FCFSAdmission",
           "ShortestPromptFirst", "TokenBudgetAdmission", "ADMISSIONS",
           "make_admission"]
