"""Multi-device execution: device meshes, sharded bundle adjustment, batch
evaluation (port of ``pyslam_tpu/parallel``).

- ``mesh.py``: a 1-D mesh of ``torch.device``s, and the row split and copy
  that place tensors on it;
- ``sharded_ba.py``: global bundle adjustment with the observations split
  over the mesh, each shard's partial normal equations reduced onto the
  first device, the reduced camera system solved there;
- batch evaluation, one sequence a device, is
  ``evaluation.manager.SlamEvaluationManager.run_distributed``.
"""
