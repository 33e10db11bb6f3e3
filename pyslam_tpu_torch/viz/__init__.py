"""Visualization layer (reference: pyslam/viz, SURVEY 2.8)."""
