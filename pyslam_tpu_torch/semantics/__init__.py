"""Semantic mapping layer (port of ``pyslam_tpu/semantics/``): the
segmentation backends and their factory, per-keyframe segmentation fused
into map points, and the segmentation metrics."""
