"""Device ops: the word-domain cluster count (CUDA kernel + plain PyTorch)."""

from .cluster import (cluster_words_op, repack_bits_words,
                      word_cluster_counts_plain, word_geometry)

__all__ = ["cluster_words_op", "repack_bits_words",
           "word_cluster_counts_plain", "word_geometry"]
