"""Depth estimation: semi-global stereo matching and the estimator factory."""
