"""Loop closing: place recognition, geometric verification, map correction
(port of ``pyslam_tpu/loop_closing/``: the bag-of-words detectors, VLAD and
SAD, and the learned global descriptors)."""
