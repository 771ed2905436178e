"""Command-line tools: tune (the detector-config sweep), doctor,
device_probe, extract_mvs, motion_scalar and heatmap."""
