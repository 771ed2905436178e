"""Device ops, each a hand-written CUDA kernel with a plain PyTorch
version: the word-domain and vote-level cluster counts, the block SAD and
the fused raw-MV vote-and-cluster count; the sweep ops over them and the
segmentation op (plain PyTorch on the device)."""

from .cluster import (cluster_map_counts_plain, cluster_map_op,
                      cluster_words_op, repack_bits_words,
                      word_cluster_counts_plain, word_geometry)
from .mv_vote import mv_cluster_counts_plain, mv_cluster_op, threshold_bound
from .sad import sad_block_grid_plain, sad_op, sad_threshold_sum
from .segmentation import segment_op
from .sweep import mv_sweep_op, sad_sweep_op, vote_sweep_op

__all__ = ["cluster_map_counts_plain", "cluster_map_op", "cluster_words_op",
           "mv_cluster_counts_plain", "mv_cluster_op", "mv_sweep_op",
           "repack_bits_words", "sad_block_grid_plain", "sad_op",
           "sad_sweep_op", "sad_threshold_sum", "segment_op",
           "threshold_bound", "vote_sweep_op", "word_cluster_counts_plain",
           "word_geometry"]
