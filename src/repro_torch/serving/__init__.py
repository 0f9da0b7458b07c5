"""The RAG serving path of the port: the tiered context database, the
batched answer (retrieve, assemble, prefill, greedy decode) and the
continuous-batching scheduler in front of both."""
from .rag import (ContextDatabase, ContextEntry, RAGConfig, RAGServer,
                  RetrievalTicket)
from .scheduler import (AdmissionError, CircuitBreaker, ContinuousScheduler,
                        DeadlineExceeded, ScheduledDSQ, SchedulerConfig,
                        SchedulerUnhealthy, ServingMetrics, ServingTicket,
                        StagedQueries, open_loop_arrivals)

__all__ = ["ContextDatabase", "ContextEntry", "RAGConfig", "RAGServer",
           "RetrievalTicket", "AdmissionError", "CircuitBreaker",
           "ContinuousScheduler", "DeadlineExceeded", "ScheduledDSQ",
           "SchedulerConfig", "SchedulerUnhealthy", "ServingMetrics",
           "ServingTicket", "StagedQueries", "open_loop_arrivals"]
