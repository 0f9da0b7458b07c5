from .dirgen import (DirDataset, brute_force_ground_truth, make_arxiv_dir,
                     make_wiki_dir)

__all__ = ["DirDataset", "make_wiki_dir", "make_arxiv_dir",
           "brute_force_ground_truth"]
