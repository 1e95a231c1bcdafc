"""Dataset synthesis, ground truth, caching and device upload."""
