"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Subpackages (importing any of them builds no kernel and touches no device):
  repro_torch.core      DSQ/DSM + PE-ONLINE / PE-OFFLINE / TrieHI scope indexes
  repro_torch.datasets  WIKI-Dir / ARXIV-Dir synthetic twins
  repro_torch.vectordb  flat executor (fp32 / int8 / PQ, tiered storage),
                        batch planner, database facade
  repro_torch.kernels   hand-written Hopper kernels (CUDA C++, ctypes-bound)
                        and their plain PyTorch versions
  repro_torch.configs   the architecture registry (ArchConfig per model)
  repro_torch.models    the dense decoder LM (prefill, decode through the
                        flash-decode kernel)
  repro_torch.serving   the RAG server: scoped retrieval, context assembly,
                        batched greedy decode

Every object that holds device state takes an explicit ``device``; the
default is ``"cuda"``, and without a card only ``device="cpu"`` runs.
"""

__version__ = "0.1.0"
