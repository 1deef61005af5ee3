"""Observability of the port: the solver's convergence reports
(:mod:`distilp_torch.obs.convergence`)."""

from .convergence import (
    CONV_DIGEST_KEYS,
    ConvergenceTrace,
    LPChunkSample,
    RoundRecord,
    SearchTrace,
    build_search_trace,
    search_trace_from_jsonl,
    search_trace_to_jsonl,
)

__all__ = [
    "CONV_DIGEST_KEYS",
    "ConvergenceTrace",
    "LPChunkSample",
    "RoundRecord",
    "SearchTrace",
    "build_search_trace",
    "search_trace_from_jsonl",
    "search_trace_to_jsonl",
]
