"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Subpackages (importing any of them builds no kernel and touches no device):
  repro_torch.core      DSQ/DSM + PE-ONLINE / PE-OFFLINE / TrieHI scope indexes
  repro_torch.datasets  WIKI-Dir / ARXIV-Dir synthetic twins
  repro_torch.vectordb  flat fp32 executor, batch planner, database facade
  repro_torch.kernels   hand-written Hopper kernels (CUDA C++, ctypes-bound)
                        and their plain PyTorch versions

Every object that holds device state takes an explicit ``device``; the
default is ``"cuda"``, and without a card only ``device="cpu"`` runs.
"""

__version__ = "0.1.0"
