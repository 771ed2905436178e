"""The plain reference of the trimmer's decisions, in NumPy.

A frozen copy of the upstream rule (Motion-Estimated-Video-Trimmer,
``motion_scanner.cpp`` and ``pipeline.cpp``): the grid geometry, the
4-neighbour cluster rule over activity masks, the block SAD of the
pixel-domain path, the gap segmentation with padding, the cut-or-copy
decision and the concat list.  It imports nothing of the program, so a
fault in the program cannot leak into the answer it is held to.
"""
