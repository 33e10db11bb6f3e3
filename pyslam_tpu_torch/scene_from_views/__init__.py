"""Multi-view end-to-end reconstruction (port of
``pyslam_tpu/scene_from_views``; reference: pySLAM ``pyslam/scene_from_views``)."""
