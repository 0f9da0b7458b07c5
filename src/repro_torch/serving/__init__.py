"""The RAG serving path of the port: the tiered context database and the
synchronous batched answer (retrieve, assemble, prefill, greedy decode).
The continuous-batching scheduler waits for ROADMAP queue 1 item 8."""
from .rag import ContextDatabase, ContextEntry, RAGConfig, RAGServer

__all__ = ["ContextDatabase", "ContextEntry", "RAGConfig", "RAGServer"]
