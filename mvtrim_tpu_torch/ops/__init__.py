"""Device ops, each a hand-written CUDA kernel with a plain PyTorch
version: the word-domain and vote-level cluster counts and the block SAD."""

from .cluster import (cluster_map_counts_plain, cluster_map_op,
                      cluster_words_op, repack_bits_words,
                      word_cluster_counts_plain, word_geometry)
from .sad import sad_block_grid_plain, sad_op, sad_threshold_sum

__all__ = ["cluster_map_counts_plain", "cluster_map_op", "cluster_words_op",
           "repack_bits_words", "sad_block_grid_plain", "sad_op",
           "sad_threshold_sum", "word_cluster_counts_plain",
           "word_geometry"]
