"""Dense volumetric mapping: voxel-hash TSDF, mesh extraction, the keyframe integrator."""
