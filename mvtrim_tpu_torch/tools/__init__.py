"""Command-line tools: tune, the detector-config sweep."""
