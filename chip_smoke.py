#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pyslam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (one line each, and any failure exits non-zero):
  1. device: a CUDA card must be present (no CPU fallback);
  2. build: compile the hand-written kernels from pyslam_tpu_torch/csrc, one
     nvcc per source, and print what ptxas reports for each;
  3. the FAST+NMS kernel against its plain PyTorch version, bit for bit:
     the one-launch pyramid call on the 8 levels of a 376x1241 stereo pair,
     the one-level call on each level and on three small test images, and
     the per-level kernel it replaced; then their times from CUDA-graph
     replays of 100 back-to-back launches (per frame and per level), the
     plain version's time, and the bound computed from this frame's pixels;
  4. tie order on the card: torch.argmin / argmax keep the first index and
     torch.sort(stable=True) keeps the input order of equal keys, at the
     shapes the matchers and the keypoint selection use;
  5. one 376x1241 stereo frame extracted on the card and on the CPU;
  6. the dense slice (plain PyTorch ops, no hand kernel): the integrator's
     SGM depth (downscale 2: 188x620, 32 disparities) of the first stereo
     pair on the card against the CPU, identical; that keyframe's 3 TSDF
     phases into a 1 << 22 table on the card against the CPU (slots, keys
     and occupied identical, tsdf/weight/color within 1e-5 relative); then
     on the card: kernel launches and summed kernel time of one SGM call
     and of one TSDF phase (torch.profiler), their times over back-to-back
     calls (CUDA events), their bounds, and the standalone TSDF rate of
     bench.py (376x1241 random depth of 4-60 m, stride 3, band 2);
  7. the main path: 60 frames of the 376x1241 synthetic stereo stream (16000
     world points, straight line, 0.8 m a frame) through Slam.track() with
     next-frame prefetch and the TSDF integrator with its SGM depth attached
     as bench.py attaches it, then finish(); checks kernel launches (one a
     frame), keyframes, local BA, tracked frames, ATE, and a non-empty
     volume that integrated every keyframe handed over; prints the table's
     load factor beside the capacity flag's sizing rule (<= 0.25) and holds
     the table (check_table): its probe sequences intact, its load under
     what the integrated keyframes can fill, the share of a further
     keyframe's updates it would drop under DROP_MAX; prints the stage
     totals and the peak device memory;
  8. the loop stage of bench.py:193-267: 150 frames of a 376x1241 stereo
     circle with a revisit tail (period 130, a 16000-point world of extent
     30 m, 2000 features on 8 levels, depth threshold 35) through
     Slam.track() with next-frame prefetch and the DBOW3 loop detector, then
     finish().  Prints FPS, p50 / p95 latency over frames 8..149 and the slowest
     frame, loops closed, tracked frames, ATE before and after each
     correction and at the end, GBA runs applied and aborted, fast_nms
     launches and the loop-closing stage timers; asserts a loop closed, every
     frame tracked, ATE under the ceiling, a GBA applied and one fast_nms
     launch a frame.  Then, on the final map: a frame of the stage
     relocalised from a pose pushed 1.1 m away, and the loop event's device
     cost:
     kernel launches and summed kernel time (torch.profiler) of one
     geometry check, the correction's pose graph (the correction without
     its GBA launched 75312 kernels and its pose graph alone 74049 when both
     were profiled, on an NVIDIA H100 80GB HBM3 at 700 W), a GBA dispatch
     (problem and first chunk) and a GBA chunk;
  9. the RGBD stage: the first RGBD_FRAMES of phase 7's stream as left
     image and sensor depth through Slam(sensor_type=RGBD).track() with
     next-frame prefetch, bf = fx * 0.54 for the virtual right coordinates,
     and the TSDF integrator of phase 7 on the sensor depth (no SGM);
     asserts every frame tracked, one fast_nms launch a frame, every keyframe integrated and ATE
     under the ceiling; prints FPS, p50 / p95 latency, keyframes, the load
     factor and the peak device memory;
 10. the monocular stage: the same 60 left images through
     Slam(sensor_type=MONOCULAR).track(); asserts initialisation no later
     than the JAX package's frame on the CPU plus a margin (MONO_*), every
     frame tracked from then on, one fast_nms launch a frame and ATE after a
     similarity alignment under the ceiling; prints what phase 9 prints and
     the initialising frame's latency;
 11. both visual odometries on those 60 frames (VisualOdometry with the
     ground-truth scale, VisualOdometryRgbd with 2000 corners): FPS, p50,
     ATE under their CPU floors, one fast_nms launch a frame; then, card
     against CPU on frames 0-1: compute_stereo_from_rgbd identical,
     find_essential + recover_pose from the same minimal samples, LK within
     1e-2 px; the launches and kernel time of one LK call, one
     find_essential + recover_pose and one monocular initialisation; and
     the kernel as these paths call it (the B = 1 pyramid, the threshold-15
     level) bit-equal to its plain version, timed beside its bound;
 12. the weight-free presets on the first PRESET_FRAMES of phase 7's stereo
     frames, each at its own
     width, with the session's descriptor gates restored afterwards; first
     every weight-free preset is built on the card through the factory and
     extracts frame 0, then:
     a. ORB2_BEBLID (512-bit BEBLID on ORB2 keypoints) with the
        DBOW3_INDEPENDENT loop detector: the 512-bit layout through map,
        keyframe store and vocabulary; asserts every frame tracked, ATE
        under FEATURE_ATE_MAX and one fast_nms launch a frame;
     b. ROOT_SIFT (cv2 SIFT on the host, RootSIFT descriptors) with
        DBOW3_INDEPENDENT: the float layout through the whole core; the
        same assertions without the kernel; when cv2 does not import it
        prints so on its own line and does not run;
     c. KAZE, card against CPU on frames 0-1: keypoints identical,
        descriptors within KAZE_DESC_TOL, the L2 brute-force matches and
        the float vocabulary's words identical; then a 20-frame KAZE stereo
        session on the card, its frames tracked and resets printed beside
        the JAX package's (which loses this stream at frame 1).
     Prints p50 / p95 latency, FPS, keyframes and ATE of each session and a
     ``features`` JSON line naming the sessions that ran.
 13. the entry point on a sequence from disk: phase 7's 60 stereo frames
     written as a KITTI odometry sequence (uint8 PNGs, times.txt, the ground
     truth as poses/00.txt) with an ORB-SLAM settings yaml of the main
     stage's camera and a config.yaml (ORB2, 2000 features on 8 levels,
     DBOW3, the main stage's TSDF flags as GLOBAL_PARAMETERS);
     a. ``pyslam_tpu_torch.main_slam.main`` in this process, on its default
        device (the card), with --volumetric, --save_state and a KITTI
        trajectory; asserts every frame tracked (OK after the frame; the
        final trajectory leaves out a frame whose reference keyframe was
        culled, as the reference's does), ATE under ENTRY_ATE_MAX against
        read_kitti_poses, one fast_nms launch a frame and the state
        folder's files; prints FPS, p50 / p95 latency, the table's load
        beside the keyframes integrated and the loops closed, and the
        stage totals;
     b. the state reloaded into a fresh Slam on the card with the TSDF
        integrator: keyframe and point counts, INIT_RELOCALIZE, the
        vocabulary checksum and the reloaded table as phase 7 holds its
        (check_table); frames 20-35 of the sequence fed to it must be OK within 5
        frames and stay OK; then the same map saved in the reference's
        schema and reloaded into another fresh Slam, with the same counts.
 14. the learned models with the JAX package's bundled weights (each asserts
     ``trained``):
     a. SuperPoint card against CPU on frames 0-1 of phase 7's stream (the
        probability map within SP_TOL, 99 % of the keypoint slots identical
        and the others at responses within SP_TOL, descriptors within
        SP_TOL); its forward time on one 376x1240 image (CUDA events), the
        FLOPs of its convolutions from the layer shapes and their share of
        the float32 peak; then a SUPERPOINT + DBOW3_INDEPENDENT stereo
        session on phase 7's 60 frames (1000 keypoints), no integrator, its
        frames tracked held to the JAX package's (WITNESS_SP);
     b. VisualOdometry with the LIGHTGLUE preset on phase 11's frames: FPS,
        p50 and ATE, held to the JAX package's ATE; LightGlue card against
        CPU on frames 0-1 (scores within LG_TOL, at most 1 % of the indices
        differing);
     c. phase 8's loop stage with the COSPLACE detector in place of DBOW3:
        150/150 tracked, ATE under ATE_MAX, one fast_nms launch a frame,
        every keyframe described (a unit 128-d descriptor, no words) and in
        the database; the relocalisation of phase 8 (reported); the
        CosPlace descriptor of one keyframe's img_vpr card against CPU
        within VPR_TOL; loops closed beside the JAX package's count.
     A ``models`` JSON line gathers their numbers.
 15. the learned local features with seeded random weights (no family has a
     checkpoint in the repository; each asserts not ``trained``), each at
     its published width on frame 0 of phase 7's stream, cropped to its own
     multiple as the JAX extractor crops:
     a. XFeat, DISK, ALIKED, R2D2, D2-Net, Key.Net with HardNet, LF-Net and
        DELF, each patch network (HardNet, SOSNet, L2Net, TFeat, GeoDesc,
        LogPolar) over the frame's 2000 ORB2 keypoints and ContextDesc over
        cv2 SIFT's keypoints (a missing cv2 fails the phase), card against
        CPU with the same weights: the network's maps within LEARNED_TOL of
        their largest magnitude, 99 % of the keypoint slots identical and
        the others at responses within LEARNED_TOL, descriptors within
        LEARNED_TOL, finite and of the preset's width; then the forward
        and extraction times on the card (CUDA events), the FLOPs from the
        layer shapes (the deformable convs and SDDH counted by hand) and
        their share of the float32 peak;
     b. stereo sessions of ORB2_HARDNET, XFEAT, DISK and ALIKED on the
        first LEARNED_FRAMES frames, each at its own feature count, no
        integrator: every frame tracked through without an exception, every
        frame's descriptors on the card, ORB2_HARDNET one fast_nms launch a
        frame (the others none); frames tracked, resets, ATE and p50 beside
        the JAX package's on the CPU with its own weights (WITNESS_LEARNED);
     c. VisualOdometry with XFEAT_LIGHTGLUE (LightGlue at input_dim 64) on
        the first LEARNED_FRAMES of phase 11's frames: FPS, p50 and ATE;
        LightGlue card against CPU on frames 0-1 as in 14b.
     A ``learned`` JSON line gathers their numbers.
 16. the dense two-view matchers and the other loop detectors, seeded
     random weights (no checkpoint in the repository):
     a. LoFTR at its published width (480x640, dims 128/196/256, 4 coarse
        pairs, 8 heads, 1024 matches) on frames 0 and 2 of phase 11's
        stream, card against CPU: conf_all within DENSE_TOL of its largest,
        LOFTR_NN_SAME of the coarse argmax identical, and with
        conf_threshold 0 in both the fine xy2 within LOFTR_XY_TOL px on the
        matches both keep; the match count at the default threshold, one
        track_pair's time and GFLOP (layer shapes and the attention and
        matching products) as a share of the float32 peak;
     b. MASt3R at DUSt3R's published width (224x224, patch 16, encoder 24 x
        1024, decoder 12 x 768, desc_dim 24) on frame 0's stereo pair of
        phase 7, card against CPU (pts3d, conf, desc, desc_conf within
        DENSE_TOL of their largest), DUSt3R's pointmaps from the same trunk
        equal to MASt3R's, one infer_pair's time and GFLOP, match_pair on
        frames 0 and 2; then the MAST3R preset through Slam.track() on the
        first MAST3R_FRAMES stereo frames: every frame's two images
        described on the card; frames tracked, resets and ATE reported (no
        floor: random weights);
     c. NETVLAD, MEGALOC, ALEXNET, HDC_DELF, VLAD (trained on phase 7's
        first four frames; its k-means held round by round card against
        CPU, both fed the CPU's centres each round: assignments identical
        but at near-ties, centres within DENSE_TOL; the descriptors then
        compared on the card's centres) and SAD through
        LoopDetector on the card and on the CPU: two frames' descriptors
        within DENSE_TOL of their largest, one description's time; DBOW3
        with a PRETRAINED vocabulary the phase trains and saves: the word
        ids identical card against CPU;
     d. phase 8's loop stage with VLAD in place of DBOW3: 150/150 tracked,
        at least VLAD_MIN_LOOPS loops (WITNESS_VLAD: the JAX package's run),
        ATE under ATE_MAX, one fast_nms launch a frame, every keyframe
        re-described after the vocabulary trained.
     A ``dense`` JSON line gathers their numbers.
 17. the depth estimators and the monocular depth upgrade, seeded random
     weights (no depth model has a checkpoint in the repository):
     a. each model at the JAX package's default configuration (DPT-lite on
        the 368x1232 crop; DepthAnythingV2 266x350 ViT-S; DepthAnything 3
        224x224 on frame 0's two images; DepthPro 1536 px, 35 patches of
        384 and the global pass; RAFT-Stereo and CREStereo on the 368x1232
        pair; MV-DUSt3R 224x224 on the pair) on phase 7's frame 0, card
        against CPU within DENSE_TOL of each map's largest magnitude, its
        parameters and outputs on the card; forward ms (CUDA events),
        GFLOP from the layer shapes and the attention and correlation
        products, share of the float32 peak, launches and kernel ms
        (torch.profiler), trained False;
     b. the SGBM upgrade: Slam(sensor_type=MONOCULAR,
        depth_estimator=DEPTH_SGBM) with the TSDF (phase 9's integrator,
        fed the estimated depth) over phase 7's 60 frames, the left image
        and the right one for the estimator (which track() hands to the
        frame too, as the reference's does); asserts the sensor reads RGBD,
        60/60 tracked, one fast_nms launch a frame, every keyframe
        integrated, the trajectory's length within DEPTH_LENGTH_TOL of the
        ground truth's (no alignment) and ATE under DEPTH_SGBM_ATE_MAX (the
        JAX package's result on the CPU plus DEPTH_ATE_MARGIN);
     c. the upgrade with DEPTH_ANYTHING_V2 and DEPTH_MAST3R on the first
        DEPTH_LEARNED_FRAMES left images, each frame's depth estimated on
        the card through Slam.track(): tracked, resets and ATE beside the
        JAX package's (random weights: no floor).
     A ``depth`` JSON line gathers their numbers.
 18. semantic mapping, seeded random weights (no segmenter has a
     checkpoint in the repository):
     a. DeepLabV3 (ResNet-50, output stride 8, the frame padded to
        376x1248), SegFormer on the full frame, CLIP at 224 px (the image
        tower dense, SEM_CLIP_LABELS' eight prompts), YOLO-seg at 256 px
        (its decode of the CPU's heads on the card too) and DETR at 256 px
        on phase 7's frame 0, card against CPU within DENSE_TOL and the
        labels identical but at near-ties; forward ms, GFLOP, share of the
        float32 peak, launches and kernel ms;
     b. phase 7's first SEM_FRAMES frames and configuration with the intensity-band
        segmenter (19 classes, the Cityscapes weights) attached through
        Slam.set_semantic_mapping, the VOXEL_SEMANTIC_GRID integrator from
        the factory and kUseSemanticsInOptimization on: every frame tracked, one
        fast_nms launch a frame, ATE under ATE_MAX, every keyframe handed
        over labelled with the bands of its image under its rounded raw
        keypoints, every valid point of a labelled keyframe scored, the
        table check; p50/p95, FPS, keyframes labelled and the last local
        BA's down-weighted observations; then one keyframe through
        integrate_semantic (COUNTING and BAYESIAN) card against CPU: slots
        and keys identical, class scores within SEM_SCORES_TOL;
     c. SEGFORMER and CLIP (FEATURE_VECTOR, ending in query_points_by_text)
        sessions of SEM_LEARNED_FRAMES frames, every keyframe segmented on
        the card (random weights: no floor).
     A ``semantic`` JSON line gathers their numbers.
 19. 3D reconstruction from views and Gaussian-splatting dense mapping,
     seeded random weights (no reconstruction model has a checkpoint in the
     repository):
     a. VGGT and Fast3R at their default configurations (224x224, patch 16,
        dim 768, 12 + 12 blocks, 12 heads) on the 6 views of
        main_scene_from_views, card against CPU within RECON_TOL of each
        output's largest magnitude (points, confidences, poses, fov, anchor
        mass; local points and confidences); forward ms, GFLOP from the
        layer shapes and the attention products, share of the float32
        peak, launches and kernel ms;
     b. ``main_scene_from_views --type geometric --views 6`` on the card:
        one fast_nms launch a view, the per-pair match counts identical to
        the same run on the CPU, every pair at least 30 matches, each view's
        rotation against the ground truth under SCENE_ROT_MAX_DEG, a finite
        non-empty cloud, the saved npz reloads;
     c. every other SceneFromViewsType through the factory on those views:
        finite (V, 4, 4) poses and a finite non-empty cloud, seconds each;
     d. phase 9's RGBD stream cut to GS_FRAMES frames through
        Slam(sensor_type=RGBD).track() with the Gaussian-splatting
        integrator at its defaults (capacity 60000, tile_k 48, 30 steps,
        window 3, stride 4; depth truncated at GS_DEPTH_TRUNC): every frame
        tracked, one fast_nms launch a frame, every keyframe integrated,
        ATE under ATE_MAX, the mean PSNR of each keyframe's view after its
        integration at least GS_PSNR_MIN (the views at the session's end
        reported), a save / load within GS_SAVE_TOL; the JAX package's
        held-out configuration (96x128) at least GS_PSNR_MIN; the drift
        witness (11 keyframes of the stream at a quarter of its size into a
        volume at its defaults): the views' mean PSNR at the session's end
        within GS_DRIFT_MARGIN_DB of the JAX package's; ms per keyframe
        integration, one rasterize's and one optimiser step's launches and
        kernel ms, the tile-score pass against its byte bound, the peak
        device memory; one full-size rasterize card against CPU;
     e. ``main_map_dense_reconstruction --frames 20`` on the card: a
        non-empty TSDF cloud that reloads.
     A ``reconstruction`` JSON line gathers their numbers.
 20. training, the large-window BA, a bag and the viewers:
     a. each trainer (models/train_{superpoint,lightglue,cosplace}.py): one
        step's loss and gradients on the card against the CPU from the same
        parameters and batch, within TRAIN_GRAD_TOL of the largest
        magnitude; one step's launches and kernel ms (torch.profiler); then
        SuperPoint at its default 1500 steps (on the JAX trainer's own
        batch draws, SP_REFERENCE_DRAWS), CosPlace at its 300 and LightGlue
        at LG_STEPS (its 6000 cut, see the constant), ms a step; each result
        written through the interop writer to an npz, reloaded by the
        port's extractor or matcher and held to the JAX package's quality
        floors for its bundled checkpoint (SuperPoint's corner precision
        and descriptor inliers, CosPlace's recall@1; LightGlue's precision
        and recall against the NN baseline are printed, and at the cut only
        its loss must fall);
     b. phase 7's stream for LARGE_BA_FRAMES frames with kUseLargeWindowBA
        on and kEveryNumFramesLargeWindowBA = 2, local mapping drained
        every frame as the reference's test drains it: every frame tracked,
        at least one large-window dispatch at kLargeBAWindowSize, one
        fast_nms launch a frame;
     c. BAG_FRAMES stereo frames of phase 7's stream written to a ROS 2 bag
        (sqlite3, 32FC1 images) and read back through dataset_factory:
        identical images, then Slam.track() on the card: every frame
        tracked, one fast_nms launch a frame;
     d. the HTML export and one /state.json poll of LiveViewer3D from b's
        map.
     A ``trainers`` JSON line gathers their numbers and the script's wall
     time (the ``[time]`` line's seconds a phase).
21. the native observation graph, the sharded GBA, the evaluation grid and
     frontend_step, on the saved state of phase 13:
     a. the g++ build's seconds; phase 13's map reloaded into a fresh Slam on
        the card: the native mirror against the map's dicts (total
        observations, the full edge list as a set); the mean host time of
        update_connections and of one local BA's edge assembly over the
        map's keyframes, their counting and edge dumps through the mirror and
        through the dict loop (numbers to record, not claims);
     b. that map's whole-map BA problem (2000 ORB2 features, 8 levels, 60
        frames) in float64, as the reference's test runs, unsharded and
        sharded over Mesh([cuda:0] * 4) and over make_mesh(): poses within
        SHARD_POSE_TOL and points within SHARD_POINT_TOL; then in float32
        through global_bundle_adjustment(use_sharded=...) on fresh reloads,
        unsharded (twice: the card's own spread) and over both meshes: each
        final cost within SHARD_COST_TOL of the unsharded solve's and the
        maps' differences printed; P, C, O, each float32 solve's ms and
        launches, and the bytes its reductions and broadcasts move (one
        card: the four shards share cuda:0 and make_mesh() is one shard, so
        no copy crosses devices);
     c. SlamEvaluationManager.run_distributed over EVAL_GRID_SEQS stereo
        line sequences of EVAL_GRID_FRAMES frames at the main stage's width
        (2000 features, 8 levels), written to disk as KITTI sequences, on
        [cuda:0] and on [cuda:0, cuda:0] (two threads on the card), each
        cell against _single_run(deterministic=True) on the card, all under
        torch's deterministic algorithms (see EVAL_GRID_FRAMES): tracked
        share equal, keyframes within EVAL_KF_TOL, ATE within EVAL_ATE_TOL,
        and whether each cell is bit-identical printed; one fast_nms launch
        a frame over each grid; the reports written;
     d. pipeline.frontend_step at __graft_entry__.py's shape (376x1241,
        M = 2048, its draws with seed 0) on the card against the CPU:
        keypoints, bits and matches identical (its random map leaves 4
        matches and no inlier, so Tcw_opt is the LM's walk on outliers and
        only printed); then frame 1 of phase 7's stream against a map of
        frame 0's stereo keypoints back-projected at the ground-truth pose
        with their descriptors, from the line's constant-velocity prediction
        pushed 0.1 m off: card against CPU keypoints, bits and matches
        identical and Tcw_opt within FRONTEND_TCW_TOL, at least
        FRONTEND_MIN_INLIERS inliers and the camera centre within
        FRONTEND_POSE_TOL_M of the ground truth; ms a call and one fast_nms
        launch a call.
     A ``distributed`` JSON line gathers their numbers and the script's wall
     time (the ``[time]`` line's seconds a phase).
Every log line starts with the seconds since the script began.  The frames
of phases 7-10 are rendered by one pool of worker processes before phase 7
runs (the RGBD frames are the stereo frames' left images with the depth of
the same render).  Once phase 8 has ended, the parts that need nothing of
this process but phase 7's first SIDE_FRAMES frames (16a LoFTR, 16c the
VPR models, 17a the depth models, 18a the semantic models, 19a-c, 19d's
held-out and drift witnesses, 19e, 20a's trainers and 21c's evaluation
grid: side_work) run in a second process on the same card, started as
``chip_smoke.py --side DIR``, beside phases 9-15; this process waits for it
when phase 16 starts, prints its log there and takes its numbers into
phases 16-21.  The loop stages of phases 8 and 16 and the SGBM upgrade of
phase 17 run with no second process beside them.
It ends with a JSON line of kernel results, the card's name and power limit,
and, last, {"ok": true, "device": {...}}.
"""

import atexit
import dataclasses
import json
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

H, W = 376, 1241
FX = 718.856
BASELINE_M = 0.54
N_FEATURES = 2000
N_LEVELS = 8
N_FRAMES = 60
FAST_TH = 20.0
BORDER = 16
ATE_MAX = 3.0
# H100 SXM published peaks at 700 W (NVIDIA data sheet): HBM bytes a second,
# and float32 operations a second outside the tensor cores counting a
# min, max, subtract or compare as one (67 TFLOP/s counts an FMA as two)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 33.5e12
# float32 operations in csrc/fast_nms.cu: the NMS of every pixel (8 max,
# compare, select), the compass pretest of every pixel inside the border
# (4 subtract, 8 compare), and each side that passes it (64 doubling + 15
# reduce min/max, subtract, compare, max or select)
OPS_NMS, OPS_PRETEST, OPS_SIDE = 10, 12, 82
GRAPH_LAUNCHES = 100
# the dense slice as bench.py:126-155 configures it
VOXEL_SIZE, SDF_TRUNC, DEPTH_TRUNC_OUTDOOR = 0.2, 0.6, 40.0
TABLE_CAPACITY = 1 << 22
TSDF_PHASES = 3
# operations of the SGM function per element, counting a min, add,
# compare, select, xor or popcount as one: the census compares of both
# images per pixel; per pixel and disparity the xor and popcount of the
# cost, the 3 adds of the 4 directions, and the winner-take-all, uniqueness
# and right-disparity minima; per step of a path, disparity and tile of the
# aggregation, the 7 of the recurrence (min of the neighbours, + P1, two
# mins, add, subtract, the running minimum)
OPS_CENSUS, OPS_COST, OPS_SUM4, OPS_WTA, OPS_STEP = 2 * 24, 2, 3, 5, 7
# bytes of one update read by the insert (coords, sdf, w, grey, valid) and
# of one table row read and written (key, occupied, tsdf, weight, color)
UPDATE_BYTES, ROW_BYTES = 3 * 4 + 4 + 4 + 4 + 1, 3 * 4 + 1 + 4 + 4 + 3 * 4
# bytes of one strided pixel read by the update generation (depth,
# intensity); its operations per pixel (2 ray directions of subtract and
# divide, 3 compares of the pixel's validity) and per update (sample depth;
# sdf subtract and divide; 2 ray products; per world coordinate a multiply,
# 2 FMAs and an add, a divide and a floor; weight clamp, multiply, subtract
# and clamp; 3 compares and 2 ands of its validity; the colour multiply)
PIXEL_BYTES, OPS_PIXEL, OPS_UPDATE = 4 + 4, 7, 1 + 2 + 2 + 3 * 6 + 4 + 5 + 1
# the dense result of phases 7 and 13 (check_table).  The table overfills
# the capacity flag's sizing rule (<= 0.25) at bench.py's configuration, so
# the check guards the insert, not the rule.  A further keyframe of the
# last frame may leave DROP_MAX of its valid updates unresolved (chip
# readings 3.06-3.10 % at phase 7's load 0.414, ~3.8 % at phase 13's 0.44-
# 0.45).  The load is held under what the integrated keyframes can fill:
# the stream's frames touch 80-188 k distinct voxels each at their ground-
# truth poses (the far wall comes close at the end: frames 50-59 add 0.02-
# 0.03 of the table each), so the load moves with how many of the last
# frames became keyframes, not with the insert; a keyframe's count moved
# by at most 0.28 % with its pose perturbed by 0.1 m and 0.3 degrees
# (CPU, tests/torch_dense_load.py's frames), KF_VOXEL_MARGIN covers it
DROP_MAX = 0.05
KF_VOXEL_MARGIN = 0.05
# the loop stage as bench.py:193-267 configures it
LOOP_FRAMES, LOOP_PERIOD = 150, 130
LOOP_SKIP = 8          # latency percentiles over frames 8.. (bench.py:251)
RELOC_FRAME = 60       # relocalised against the final map after the stage
RENDER_CHUNK = 10
# the second process (SideProcess): its CPU threads and niceness, so that
# the sessions beside it keep the host, and how long after the start this
# process waits for it
SIDE_THREADS, SIDE_NICE = 4, 10
SIDE_DEADLINE_S = 950.0
SIDE_FRAMES = 6        # phase 7's frames the second process's parts use
# phases 9-11: the main stage's stream as RGBD (left image and its depth)
# and monocular (left image), and the visual odometries on it
VO_FAST_TH = 15.0      # the RGBD VO's FAST threshold (visual_odometry_rgbd.py)
# the JAX package on the monocular line (python -m tests.torch_sensor_stage
# --package jax --sensor mono, CPU, x64 off) initialises at frame 34; the
# port may take one more advance of the reference frame (every 10 failures)
MONO_REF_INIT_FRAME, MONO_INIT_MARGIN = 34, 10
# the floors of the visual odometries' CPU tests (tests/test_vo.py,
# tests/test_lk_vo_rgbd.py)
VO_MONO_ATE_MAX, VO_RGBD_ATE_MAX = 0.4, 0.35
# phase 12: the weight-free presets on the main stage's stream.  The JAX
# package (python -m tests.torch_sensor_stage --package jax --sensor stereo
# --preset P [--loop DBOW3_INDEPENDENT], CPU, x64 off) tracks all 60 frames
# with ORB2_BEBLID (18 keyframes, ATE 0.1515 m) and with ROOT_SIFT (60
# keyframes, ATE 0.0513 m), both with DBOW3_INDEPENDENT; it loses KAZE at
# frame 1 and resets (WITNESS_KAZE: 8 of 20 frames tracked, 7 resets)
FEATURE_ATE_MAX = 0.25
KAZE_FRAMES = 20
KAZE_DESC_TOL = 1e-3
WITNESS_KAZE = (8, 7)
# phase 13: main_slam on phase 7's 60 frames written as a KITTI sequence;
# the ATE floor of tests/test_slam_e2e.py, the main stage's depth threshold,
# and the frames fed to the reloaded session, which must be OK within
# ENTRY_RELOC_WITHIN frames and stay OK
ENTRY_ATE_MAX = 0.25
ENTRY_DEPTH_THRESHOLD = 35.0
ENTRY_RELOC_FRAMES = (20, 36)
ENTRY_RELOC_WITHIN = 5
# phases 14a-c: the learned models.  The JAX package on the CPU (x64 off):
# SUPERPOINT + DBOW3_INDEPENDENT on phase 7's stream (python -m
# tests.torch_sensor_stage --package jax --sensor stereo --preset SUPERPOINT
# --loop DBOW3_INDEPENDENT) loses frame 1 and resets: 28 of 60 frames
# tracked, 27 resets, ATE 13.1819 m (the port on the CPU the same); its
# LIGHTGLUE VO on phase 11's frames (--sensor vo --preset LIGHTGLUE) makes
# no match (the matcher's best confidence stays under its 0.1 threshold):
# ATE 13.8545 m; bench.py's loop stage with COSPLACE (python -m
# tests.torch_loop_stage --package jax --loop COSPLACE) tracks 143 of 150
# frames, closes 3 loops, ATE 0.6465 m.  The SuperPoint session may track
# SP_TRACK_MARGIN frames fewer than the reference (float32 differences in a
# session that resets every second frame); the VO's ATE is held to the
# reference's
SP_FEATURES = 1000
SP_TOL = LG_TOL = VPR_TOL = 1e-4
WITNESS_SP = (28, 27, 13.1819)
SP_TRACK_MARGIN = 2
WITNESS_VO_LG_ATE, VO_LG_ATE_TOL = 13.8545, 1e-3
WITNESS_COSPLACE = (143, 3, 0.6465)
# the depth of earlier paths, cut for the later phases' time: phase 12's
# ORB2_BEBLID and ROOT_SIFT sessions run the first PRESET_FRAMES of phase
# 7's 60 frames (30 for phase 16, the whole script then 913.8 s on a slower
# host; 20 for phase 19, whose first full runs took 1026.8 s and, on a
# slower host, 1211.0 s); the sessions of 15b-c, 16b and 18c their first 10
# frames (LEARNED_FRAMES, MAST3R_FRAMES, SEM_LEARNED_FRAMES, 20 before
# phase 19), 18b phase 7's first SEM_FRAMES and phase 9 the first
# RGBD_FRAMES of its 60 (the later phases take all 60).  (Phase 14c's COSPLACE
# stage cannot be cut so: its ATE stays under ATE_MAX only through the
# loop's correction near frame 145; 70 frames ended at 3.7629 m.)
PRESET_FRAMES = 20
RGBD_FRAMES = 30
# float32 operations a second of the H100 SXM outside the tensor cores,
# counting a multiply-add as two (NVIDIA data sheet, 700 W)
PEAK_FP32_FLOPS = 67e12
# phases 15a-c: the learned local features, seeded random weights (no
# family has a checkpoint in the repository).  Card against CPU: maps within
# LEARNED_TOL of their largest magnitude, 99 % of the keypoint slots
# identical, the rest at responses within LEARNED_TOL, descriptors within
# LEARNED_TOL.  The sessions run the first LEARNED_FRAMES frames.
LEARNED_TOL = 1e-4
LEARNED_FRAMES = 10
# ALIKED refines its keypoints by a soft-argmax: a slot is identical when
# its grid keypoint is, its refined position within this many px
LEARNED_XY_TOL = {"ALIKED": 1e-4}
# The keypoints are held as a set: 99 % of the CPU's valid keypoints among the
# card's, and every slot that differs at a response within LEARNED_TOL of the
# CPU's.  Slot for slot, a flat random-weight score orders its near-ties as
# each device's convolutions round: D2-Net (2000 responses in 0.244-0.533)
# kept 95.5 % of its slots, R2D2 (0.2050-0.2120) 98.35 %, at response gaps
# of 3.8e-6 and 4.5e-8 (the first chip runs of phase 15)
LEARNED_MIN_SAME = 0.99
# operations of one bilinear tap value (ALIKED's sampler):
# (v00 (1 - ax) + v01 ax) (1 - ay) + (v10 (1 - ax) + v11 ax) ay
BILINEAR_OPS = 9
# operations of one linear tap value along a row (RAFT's lookup, CREStereo's
# window): v0 (1 - f) + v1 f
BILINEAR_1D_OPS = 4
# (name, models module, extractor, keypoint slots, image layout, descriptor)
LEARNED_MODELS = (
    ("XFeat", "xfeat", "XFeatExtractor", 2000, "gray", "XFEAT"),
    ("DISK", "disk", "DiskExtractor", 2000, "rgb", "DISK"),
    ("ALIKED", "aliked", "AlikedExtractor", 2000, "rgb", "ALIKED"),
    ("R2D2", "r2d2", "R2D2Extractor", 2000, "rgb", "R2D2"),
    ("D2-Net", "d2net", "D2NetExtractor", 2000, "rgb", "D2NET"),
    ("Key.Net+HardNet", "keynet", "KeyNetExtractor", 2000, "gray", "HARDNET"),
    ("LF-Net", "lfnet", "LFNetExtractor", 1000, "gray", "LFNET"),
    ("DELF", "delf", "DELFExtractor", 1000, "gray", "DELF"),
)
PATCH_NETS = ("HARDNET", "SOSNET", "L2NET", "TFEAT", "GEODESC", "LOGPOLAR")
LEARNED_SESSIONS = ("ORB2_HARDNET", "XFEAT", "DISK", "ALIKED")
# the JAX package on the CPU with its own PRNGKey(0) weights, x64 off (python
# -m tests.torch_sensor_stage --package jax --sensor stereo --preset P
# --frames 20): frames tracked, resets, ATE (m).  The port draws other random
# weights, so these are beside its results, not a floor
WITNESS_LEARNED = {"ORB2_HARDNET": (20, 0, 0.0378), "XFEAT": (20, 0, 4.5123),
                   "DISK": (14, 1, 5.1285), "ALIKED": (20, 0, 1.0696)}
# phases 16a-d: the dense two-view matchers and the other loop detectors,
# seeded random weights.  LoFTR card against CPU: conf_all within DENSE_TOL
# of its largest, LOFTR_NN_SAME of the coarse argmax identical, the fine
# xy2 within LOFTR_XY_TOL px on the matches both keep (conf_threshold 0);
# MASt3R's maps and the VPR descriptors within DENSE_TOL of their largest
DENSE_TOL = 1e-4
# 16c: VLAD's k-means is held round by round (one near-tie of the float32
# argmin sends the later rounds of two devices apart, so the trained end
# states are not compared): both devices fed the CPU's centres, assignments
# identical except where the two best of |c|^2 - 2 d.c are within
# KMEANS_NEAR_TIE of the largest magnitude
KMEANS_NEAR_TIE = 1e-4
LOFTR_NN_SAME = 0.99
LOFTR_XY_TOL = 1e-3
MAST3R_FRAMES = 10
VPR_DETECTORS = ("NETVLAD", "MEGALOC", "ALEXNET", "HDC_DELF", "VLAD", "SAD")
# bench.py's loop stage with VLAD: the JAX package on the CPU (python -m
# tests.torch_loop_stage --package jax --loop VLAD, x64 off) tracks 142 of
# 150 frames (frames 142-149 lost after its last correction), closes 3 loops
# (kf 28 with kf 18 at frame 70 and kf 45 with kf 33 at frame 120, keyframes
# ten apart on the circle, then kf 57 with kf 7 at frame 141, the revisit),
# ATE 0.6524 m.  The port on the CPU (--package port) tracks 150/150 and
# closes the revisit only (kf 49 with kf 1 at frame 133), ATE 0.5995 m, as
# with COSPLACE (phase 14c).  The near loops are chance events: VLAD over
# ORB2's bits scores the most similar stored keyframes at 0.18-0.28, no
# higher than the covisible neighbours (python -m tests.torch_loop_stage
# --loop VLAD --candidates; ROADMAP.md section 3), so the floor is the
# revisit's one loop
WITNESS_VLAD = (142, 3, 0.6524)
VLAD_MIN_LOOPS = 1
# phase 17: the depth estimators.  17b's floors: the trajectory's length
# within DEPTH_LENGTH_TOL of the ground truth's without alignment
# (tests/test_depth_in_slam.py:64-70), and ATE under the JAX package's on
# the same 60 frames on the CPU (python -m tests.torch_sensor_stage --package
# jax --sensor mono --depth-estimator sgbm, x64 off: WITNESS_DEPTH_SGBM,
# tracked, resets, ATE m; 55 keyframes, 47.228 m against 47.200 m; 55 and
# 0.0485 m in a later run) plus DEPTH_ATE_MARGIN.  That run's back end is
# idle at every keyframe decision (jax.Array.is_ready on the CPU), so it
# makes a keyframe nearly every frame; under the port's readiness rule
# (--polls-like-the-port: WITNESS_DEPTH_SGBM_PORT_READINESS) it makes its
# keyframes at the port's CPU frames (0-9, then every second frame: 34
# left in the map) and ends at 0.0720 m, the port on the CPU at 0.0981 m
# (0.1005 m given the reference's pyramid).  On the card the 8 ms
# wall-clock budget leaves the back end busy and its queue full on two
# frames of three: 23 keyframes, 0.112 m (tests/torch_chip_phase.py 17
# --log-kf).  The port's sessions on these frames ended at 0.110-0.158 m
# (phase 7, stereo) and 0.122-0.175 m (phase 9, RGBD) in five earlier card
# runs of this script; the ceiling stays under the 0.25 m of
# tests/test_slam_e2e.py
DEPTH_LENGTH_TOL = 0.25
WITNESS_DEPTH_SGBM = (60, 0, 0.0572)
WITNESS_DEPTH_SGBM_PORT_READINESS = (60, 0, 0.0720)
DEPTH_ATE_MARGIN = 0.15
DEPTH_SGBM_ATE_MAX = WITNESS_DEPTH_SGBM[2] + DEPTH_ATE_MARGIN
# 17c: the JAX package on the first DEPTH_LEARNED_FRAMES left images with its
# PRNGKey(0) weights (--depth-estimator depth_anything_v2 | mast3r --frames
# 20): tracked, resets, ATE (m); beside the port's, not a floor
DEPTH_LEARNED_FRAMES = 20
WITNESS_DEPTH_LEARNED = {"depth_anything_v2": (3, 1, float("nan")),
                         "mast3r": (14, 1, 3.8724)}


# phase 18: semantic mapping.  18a holds each model card against CPU within
# DENSE_TOL; 18b runs phase 7's stream and configuration with the
# intensity-band segmenter, the semantic integrator and the BA weighting,
# to phase 7's floor (60/60 tracked, one fast_nms launch a frame, ATE under
# ATE_MAX, the table check), and holds one keyframe's integrate_semantic
# card against CPU: slots and keys identical, class scores within
# SEM_SCORES_TOL of their largest (the card adds in atomic order); 18c runs
# SEGFORMER and CLIP (FEATURE_VECTOR) sessions of SEM_LEARNED_FRAMES frames
SEM_SCORES_TOL = 1e-5
SEM_LEARNED_FRAMES = 10
SEM_FRAMES = 30
SEM_CLIP_LABELS = ("floor", "wall", "ceiling", "furniture", "object", "person", "vehicle",
                   "vegetation")


# phase 19: 3D reconstruction from views and Gaussian-splatting dense
# mapping, seeded random weights.  19a holds VGGT and Fast3R card against
# CPU within RECON_TOL of each output's largest magnitude, on the
# SCENE_VIEWS views of main_scene_from_views.  19b's floor on each view's
# rotation against the ground truth: the JAX package's GEOMETRIC on the CPU
# (x64 off, PRNGKey(3)) ends at 0.6988 deg at worst on these views; the
# port's on the CPU over 48 generator seeds at 0.540-2.399 deg (the spread
# of the float32 RANSAC's draws over the 5-pair chain: 1.86 deg); the floor
# is their sum, rounded up.  19d runs phase 9's RGBD stream cut to GS_FRAMES
# frames with the integrator at its defaults.  The JAX package's own floor
# for a rendered view, GS_PSNR_MIN (tests/test_gaussian_splatting.py:96, a
# held-out frame after 6 keyframes at 96x128), holds in that configuration
# on the card, and in the session on the mean PSNR of each keyframe's view
# right after its own integration (seeding and its steps); the views' PSNR
# at the session's end is reported (13.1-18.1 dB, mean 15.1, on an H100
# at 700 W: a keyframe's view is fitted only while it is among the
# window's 3).  A save / load renders within GS_SAVE_TOL; one full-size
# rasterize card against CPU within RECON_TOL, the tiles' selections
# identical but at near-ties (scores or depths within GS_TIE_TOL of the
# tile's largest)
RECON_TOL = 1e-4
SCENE_VIEWS = 6
SCENE_ROT_MAX_DEG = 2.6
GS_FRAMES = 20
# the integrator's depth truncation for the session: past the stream's
# depth range (4-80 m), since the PSNR counts every pixel (at phase 9's 40 m
# the volume would hold 40-44 % of a frame's pixels, against 88 % with depth)
GS_DEPTH_TRUNC = 100.0
GS_PSNR_MIN = 16.0
GS_SAVE_TOL = 1e-5
GS_TIE_TOL = 1e-4
# 19d's drift witness (tests/torch_gs_drift.py): GS_DRIFT_KEYFRAMES of phase
# 9's stream at their ground-truth poses, at 1/GS_DRIFT_SCALE of its size,
# into a volume at its defaults.  The mean PSNR of the views at the
# session's end is the JAX package's GS_DRIFT_JAX_END_DB on the CPU (x64
# off); four runs with every depth moved by one float32 rounding step read
# 14.1454-14.1686, and the port reads 14.1321 on the CPU.  The card's mean
# is held within GS_DRIFT_MARGIN_DB of it, either side.
GS_DRIFT_KEYFRAMES = [0, 2, 4, 6, 8, 10, 11, 13, 15, 17, 19]
GS_DRIFT_SCALE = 4
GS_DRIFT_JAX_END_DB = 14.1131
GS_DRIFT_MARGIN_DB = 0.3
DENSE_ENTRY_FRAMES = 20
# phase 20: card against CPU for one training step, relative to the largest
# magnitude of the loss and of the gradient
TRAIN_GRAD_TOL = 1e-4
# 20a trains SuperPoint on the JAX trainer's own batch draws (its
# jax.random.randint of PRNGKey(1)'s splits, saved by tests/torch_jax_draws.py
# to SP_REFERENCE_DRAWS; the port's trainer takes them as ``indices``).  At
# the port's own seed-0 generator draws the descriptor floor (inliers >= 0.5
# over ~20 mutual matches) read 0.455 and seeds 0-9 met it 6 times in 10
# (0.30-0.625); on the reference's draws 0.789 (NVIDIA H100 80GB HBM3 at
# 700 W, tests/torch_train_spread.py; the JAX trainer itself 0.611 on a CPU):
# the floor follows the data order, and the reference's order is the one
# the reference's floor was set on (PERF.md section 6)
SP_REFERENCE_DRAWS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                                  "superpoint_reference_draws.npy")
# LightGlue's trainer runs 6000 steps by default.  On the card's host a
# step takes 130-140 ms (2000 steps in 280.0 s, 200 in 26.0 s on an NVIDIA
# H100 80GB HBM3 at 700 W): its 16 pairs come from the reference's
# per-keypoint numpy generator (~50 ms a batch on a CPU core), then ~2.1k
# launches of forward, backward and Adam run 6.0 ms of kernels.  So the
# default would take ~800 s, and 200 steps put the script over 1000 s
# (1021.8 s).  Phase 20 runs LG_STEPS, prints the JAX package's floors
# beside the NN baseline, and asserts only that the loss falls (the mean
# of the last LG_LOSS_WINDOW steps under the first's)
LG_STEPS = 50
LG_LOSS_WINDOW = 25
SP_STEPS, CP_STEPS = 1500, 300   # the SuperPoint and CosPlace trainers' defaults
LARGE_BA_FRAMES = 20
BAG_FRAMES = 10
# phase 21: the sharded GBA's iterations and the reference's tolerances
# (tests/test_parallel.py:25-26: poses within 1e-5, points within 1e-4) on
# the full-width problem in float64, as that test runs; in float32, the
# GBA's own type, the card's atomic adds alone move the map's weakly held
# points by up to 444 m between two unsharded solves of the same problem
# (an NVIDIA H100 80GB HBM3 at 700 W: 3150 points, final costs equal to
# 1e-6), so there each variant is held to the unsharded solve's final
# cost.  The JAX package's float32 solve places them as loosely: on a
# saved phase-13 map on the CPU its points under 0.5 degrees of parallax
# lie up to 1.04 m from the float64 solution (the port's 0.35 m), where
# the two packages' float64 solves agree to 4e-9 m
# (tests/torch_gba_placement.py).  The
# evaluation grid: two line sequences at the main stage's width, the steps
# and the 10 frames of tests/test_eval_distributed.py's grid, held to their
# serial deterministic runs under torch's deterministic algorithms: with the
# default ones the atomic adds made a step-0.3 m cell's ATE 1.2723 m in one
# run and 0.7808 m in the next (the same card).  Both packages give the
# same cells on the same PNGs on the CPU (tests/torch_eval_grid_witness.py:
# ATE 0.0401 and 0.9015 m in the JAX package, 0.0266 and 0.9011 m in the
# port): frame 1 is tracked from frame 0's pose without a motion model, and
# at the 0.32 m step its pose LM stalls 0.013 m from frame 0, so every later
# frame follows a map that barely moves; the 0.30 m step's converges on
# the CPU, and both steps' cells ended at 0.78-1.27 m in earlier card runs.
# frontend_step's real-case floors
SHARD_GBA_ITERS = 10
SHARD_POSE_TOL, SHARD_POINT_TOL = 1e-5, 1e-4
SHARD_COST_TOL = 1e-4
EVAL_GRID_SEQS, EVAL_GRID_FRAMES = 2, 10
EVAL_ATE_TOL, EVAL_KF_TOL = 0.01, 1
FRONTEND_MAP_POINTS = 2048
FRONTEND_CALLS = 5
FRONTEND_MIN_INLIERS, FRONTEND_POSE_TOL_M = 100, 0.05
FRONTEND_TCW_TOL = 1e-4


T_START = time.perf_counter()
PHASE_START = []      # (phase, time it started), for the [time] line


def log(msg):
    """One line of the script's log, stamped with the seconds since it began."""
    print(f"{time.perf_counter() - T_START:7.1f} {msg}", flush=True)


def synth_image(rng, h, w, n_blobs=80):
    """Random rectangles on a gradient background (many corners)."""
    img = np.tile(np.linspace(40, 90, w, dtype=np.float32), (h, 1))
    for _ in range(n_blobs):
        y = rng.integers(20, h - 40)
        x = rng.integers(20, w - 40)
        bh = rng.integers(6, 24)
        bw = rng.integers(6, 24)
        img[y:y + bh, x:x + bw] = rng.uniform(120, 250)
    return img


def band_image(rng, band=32):
    """Corners on the row-band boundaries of the TPU kernel's tiling."""
    h, w = 3 * band + 17, 160
    img = np.full((h, w), 50.0, np.float32)
    for yc in (band, 2 * band - 1, 2 * band):
        img[yc - 4:yc + 4, 60:80] = 200.0
        img[yc - 4:yc + 4, 100:120] = 220.0
    return img + rng.uniform(0.0, 2.0, (h, w)).astype(np.float32)


def bench_stream(sensor="STEREO"):
    """The main stage's stream; ``sensor`` (STEREO, RGBD, MONOCULAR) sets
    which images it renders beside the left one."""
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.io.synthetic import SyntheticDataset, SyntheticWorld

    extent = max(60.0, (N_FRAMES * 0.8 + 30.0) / 1.4)
    world = SyntheticWorld(n_points=16000, extent=extent, depth_range=(4.0, 80.0))
    return SyntheticDataset(num_frames=N_FRAMES, h=H, w=W, fx=FX, baseline=BASELINE_M,
                            trajectory="line", step=0.8, sensor_type=SensorType[sensor],
                            world=world)


def loop_stream():
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.io.synthetic import SyntheticDataset, SyntheticWorld

    world = SyntheticWorld(n_points=16000, extent=30.0, depth_range=(4.0, 80.0))
    return SyntheticDataset(num_frames=LOOP_FRAMES, h=H, w=W, fx=FX, baseline=BASELINE_M,
                            trajectory="loop", period=LOOP_PERIOD,
                            sensor_type=SensorType.STEREO, world=world)


def render_loop_frames(first, last):
    """Frames [first, last) of the loop stream (a worker process)."""
    ds = loop_stream()
    return [(ds.getImage(i), ds.getImageRight(i), ds.getTimestamp(i))
            for i in range(first, last)]


def render_rgbd_frames(first, last):
    """Frames [first, last) of the main stage's stream as RGBD: (left,
    depth, timestamp) (a worker process)."""
    ds = bench_stream("RGBD")
    return [(ds.getImage(i), ds.getDepth(i), ds.getTimestamp(i)) for i in range(first, last)]


def render_main_rgbd_frames(first, last):
    """Frames [first, last) of the main stage's stream as (left, right,
    timestamp, depth), the depth from the left image's own render as the
    RGBD stream's getDepth takes it (one render fewer a frame; a worker
    process)."""
    ds = bench_stream()
    out = []
    for i in range(first, last):
        left, zbuf = ds._render(ds._Tcw(i))
        depth = np.where(np.isfinite(zbuf), zbuf, 0.0).astype(np.float32)
        out.append((left, ds.getImageRight(i), ds.getTimestamp(i), depth))
    return out


def render_all(*streams):
    """The frames [0, n) of each (fn, n) of ``streams``, rendered in chunks
    by one pool of up to 8 worker processes: one list a stream."""
    with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        jobs = [[pool.submit(fn, a, min(a + RENDER_CHUNK, n)) for a in range(0, n, RENDER_CHUNK)]
                for fn, n in streams]
        return [[f for job in chunks for f in job.result()] for chunks in jobs]


def render(fn, n):
    """fn's frames [0, n) rendered in chunks by up to 8 worker processes."""
    return render_all((fn, n))[0]


def _json_value(x):
    """numpy scalars and arrays as JSON values (json.dump's default)."""
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.bool_):
        return bool(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    return float(x)


class SideProcess:
    """side_work in a second process on the same card: this script with
    ``--side DIR``, on ``frames`` (phase 7's first SIDE_FRAMES, written to
    DIR/frames.npz), its output going to DIR/side.log, which join() or
    stop() prints, and its numbers to DIR/side.json."""

    def __init__(self, frames):
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_side_")
        np.savez(os.path.join(self.dir, "frames.npz"), left=np.stack([f[0] for f in frames]),
                 right=np.stack([f[1] for f in frames]),
                 ts=np.asarray([f[2] for f in frames], np.float64))
        self.log_path = os.path.join(self.dir, "side.log")
        self.out = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--side", self.dir, repr(T_START)],
            stdout=self.out, stderr=subprocess.STDOUT)
        atexit.register(self.stop)

    def join(self):
        """Wait for the second process, at most until SIDE_DEADLINE_S after
        the script began; print its log; return its numbers."""
        t0 = time.perf_counter()
        try:
            rc = self.proc.wait(timeout=max(1.0, SIDE_DEADLINE_S - (t0 - T_START)))
        except subprocess.TimeoutExpired:
            rc = None
        waited = time.perf_counter() - t0
        path = os.path.join(self.dir, "side.json")
        numbers = None
        if rc == 0:
            with open(path) as f:
                numbers = json.load(f)
        self.stop()
        if rc is None:
            raise SystemExit(f"chip_smoke: the second process still ran {SIDE_DEADLINE_S} s "
                             f"after the start")
        if rc != 0:
            raise SystemExit(f"chip_smoke: the second process failed, exit {rc}")
        log(f"[side] waited {waited:.1f} s for the second process; its seconds a part "
            + json.dumps(numbers["seconds"]))
        return numbers

    def stop(self):
        """Stop the second process if it still runs, print what it wrote and
        remove its directory."""
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if not self.out.closed:
            self.out.close()
            with open(self.log_path) as f:
                sys.stdout.write(f.read())
            sys.stdout.flush()
        shutil.rmtree(self.dir, ignore_errors=True)


def median_ms(fn, n=20):
    """Median of n timings of one eager call (CUDA events around it)."""
    import torch

    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, n=GRAPH_LAUNCHES, reps=5):
    """Device time of one call of fn: fn captured n times back to back in a
    CUDA graph, one event pair around a replay, divided by n; the median of
    reps replays after a warm-up (the host's enqueue time is not in it)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def fast_work(levels, threshold, border):
    """Bytes and float32 operations the FAST+NMS kernel's function needs on
    these levels: inputs read once, outputs written once, and a side's full
    score only where the kernel's compass pretest lets it through (two
    neighbouring compass points past the threshold); with the share of
    interior pixels that pass on some side."""
    import torch

    from pyslam_tpu_torch.ops.fast import CIRCLE

    n_bytes = n_ops = n_inside = n_pass = 0
    for x in levels:
        b, h, w = x.shape
        n_bytes += 2 * 4 * x.numel()
        n_ops += OPS_NMS * x.numel()
        inner = x[:, border:h - border, border:w - border]
        if inner.numel() == 0:
            continue
        d = [x[:, border + dy:h - border + dy, border + dx:w - border + dx] - inner
             for dy, dx in (CIRCLE[0], CIRCLE[4], CIRCLE[8], CIRCLE[12])]
        sides = []
        for flags in ([v > threshold for v in d], [v < -threshold for v in d]):
            sides.append(flags[0] & flags[1] | flags[1] & flags[2] | flags[2] & flags[3]
                         | flags[3] & flags[0])
        n_inside += inner.numel()
        n_pass += int((sides[0] | sides[1]).sum())
        n_ops += OPS_PRETEST * inner.numel() + OPS_SIDE * int(sides[0].sum() + sides[1].sum())
    bytes_ms = n_bytes / PEAK_BYTES_S * 1e3
    ops_ms = n_ops / PEAK_OPS_S * 1e3
    return dict(bytes=n_bytes, ops=n_ops, pass_share=n_pass / max(n_inside, 1),
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def check_ties(dev):
    """First-index argmin / argmax and stable sort on the card, held to
    numpy (which keeps the first index and, with kind="stable", the input
    order) on integer-valued keys with many ties."""
    import torch

    rng = np.random.default_rng(1)
    checked = 0
    # matchers' distance matrices, and the aggregated SGM volume of the
    # integrator's depth (188x620, 32 disparities)
    # and the RANSAC's best hypothesis (argmax of 300 int64 inlier counts)
    for shape, dtypes in (((2000, 2000), (torch.int32, torch.float32)),
                          ((2000, 8192), (torch.int32, torch.float32)),
                          ((4, 2000, 2000), (torch.int32, torch.float32)),
                          ((188, 620, 32), (torch.int32, torch.float32)),
                          ((300,), (torch.int64, torch.int32))):
        for dtype in dtypes:
            keys = rng.integers(0, 4, shape)
            x = torch.as_tensor(keys).to(dev, dtype)
            for dim in (-1, -2)[:len(shape)]:
                for name, fn, ref in (("argmin", torch.argmin, np.argmin),
                                      ("argmax", torch.argmax, np.argmax)):
                    got = fn(x, dim).cpu().numpy()
                    assert np.array_equal(got, ref(keys, axis=dim)), (name, shape, dtype, dim)
                    checked += 1
    # the keypoint selection's sorts: (2, cells, 256) blocks and the flat
    # survivors, descending, with ties and -inf
    for shape in ((2, 1872, 256), (2, 1872 * 6)):
        keys = rng.integers(0, 6, shape).astype(np.float32) * 10.0
        keys[keys == 0.0] = -np.inf
        idx = torch.sort(torch.as_tensor(keys).to(dev), dim=-1, descending=True,
                         stable=True)[1].cpu().numpy()
        assert np.array_equal(idx, np.argsort(-keys, axis=-1, kind="stable")), shape
        checked += 1
    return checked


def build_integrator(cam, dev, kind=None):
    """The TSDF integrator (or another ``VolumetricIntegratorType``) with
    its SGM depth provider, with the flags and factory arguments of
    bench.py:138-155."""
    from pyslam_tpu_torch.config_parameters import Parameters
    from pyslam_tpu_torch.dense.volumetric_integrator import (
        VolumetricIntegratorType, volumetric_integrator_factory)

    Parameters.kVolumetricIntegrationUseDepthEstimator = True
    Parameters.kVolumetricIntegrationDepthEstimatorType = "sgbm"
    Parameters.kVolumetricIntegrationDepthTruncOutdoor = DEPTH_TRUNC_OUTDOOR
    return volumetric_integrator_factory(
        kind or VolumetricIntegratorType.TSDF, camera=cam,
        environment_type=type("E", (), {"name": "OUTDOOR"})(),
        voxel_size=VOXEL_SIZE, sdf_trunc=SDF_TRUNC, device=dev)


def profile_call(fn):
    """Kernel launches and summed kernel time (ms) of one call of fn on the
    card, from torch.profiler (copies and fills not counted as launches)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not e.key.startswith(("Memcpy", "Memset"))]
    return (sum(e.count for e in kernels),
            sum(e.self_device_time_total for e in kernels) / 1e3)


def top_kernels(fn, k=5):
    """The ``k`` kernels of one call of fn with the most device time:
    [(name, launches, ms)], from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    return [(e.key[:60], e.count, round(e.self_device_time_total / 1e3, 3))
            for e in kernels[:k]]


def events_ms(fn, n=20):
    """Time of one call of fn: CUDA events around n back-to-back calls after
    two warm-up calls, divided by n (where the host enqueues more slowly than
    the card runs, this is the host's time)."""
    import torch

    fn()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound(n_bytes, n_ops):
    bytes_ms = n_bytes / PEAK_BYTES_S * 1e3
    ops_ms = n_ops / PEAK_OPS_S * 1e3
    return dict(bytes=n_bytes, ops=n_ops, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def sgm_work(hs, ws, n_disp, tile=32, halo=16):
    """Bytes (two float32 images in, the disparity map out) and operations
    (OPS_* above) of sgm_disparity at hs x ws with n_disp disparities and the
    tiled aggregation's warm-up."""
    pixels = hs * ws
    paths = 0
    for S, T in ((ws, hs), (ws, hs), (hs, ws), (hs, ws)):
        paths += -(-S // tile) * T
    n_ops = (OPS_CENSUS * pixels + (OPS_COST + OPS_SUM4 + OPS_WTA) * pixels * n_disp
             + OPS_STEP * (halo + tile - 1) * paths * n_disp)
    return bound(3 * 4 * pixels, n_ops)


def keyframe_updates(vol, est, cam, left, right, Twc):
    """The voxel updates of one keyframe into ``vol``, one tuple a TSDF
    phase (depth from ``est``), as the integrator makes them."""
    import torch

    from pyslam_tpu_torch.dense.tsdf import depth_to_voxel_updates

    dev = vol.device
    depth = est.infer_depth_device(left, right)
    inten = torch.as_tensor(np.asarray(left, np.float32), device=dev)
    K = torch.as_tensor(np.asarray(cam.K, np.float32), device=dev)
    # a volume loaded from a file picks its stride at its first integrate,
    # as the integrator does
    stride = vol.stride or int(np.clip(vol.voxel_size * cam.fx / max(vol.depth_trunc, 1e-6),
                                       1, 4))
    T = torch.as_tensor(np.asarray(Twc, np.float32), device=dev)
    for phase in range(TSDF_PHASES):
        yield depth_to_voxel_updates(depth, inten, T, K, vol.voxel_size, vol.sdf_trunc,
                                     vol.depth_trunc, stride, vol.band_steps, phase,
                                     TSDF_PHASES)


def frame_voxels(vol, est, cam, frames, poses):
    """The distinct voxels each frame's updates touch (all TSDF phases) at
    its ground-truth pose: the most a keyframe there can add to a table."""
    import torch

    out = []
    for (left, right, _), Twc in zip(frames, poses):
        coords = torch.cat([u[0][u[4]] for u in keyframe_updates(vol, est, cam, left, right,
                                                                 Twc)])
        out.append(int(torch.unique(coords, dim=0).shape[0]))
    return out


def check_table(table, n_integrated, voxels_per_frame, drop):
    """Phase 7's and 13's check of the dense result: the table's probe
    sequences intact (``voxel_hash.probe_faults``: no key displaced beyond
    the claim rounds, no hole before a key, no key in two slots), its load
    under the most ``n_integrated`` keyframes of the stream can fill
    (``load_ceiling``), and the drop share under ``DROP_MAX``.  Returns the
    numbers; raises AssertionError on a fault."""
    from pyslam_tpu_torch.ops import voxel_hash

    faults = voxel_hash.probe_faults(table)
    load = faults["occupied"] / table.capacity
    ceiling = load_ceiling(voxels_per_frame, n_integrated, table.capacity)
    out = dict(faults, load=load, load_ceiling=ceiling, integrated=n_integrated,
               drop_share=drop)
    assert faults["beyond"] == faults["holes"] == faults["duplicates"] == 0, out
    assert load <= ceiling, out
    assert drop <= DROP_MAX, out
    return out


def load_ceiling(voxels_per_frame, n_integrated, capacity):
    """The load of a table that holds every voxel of the ``n_integrated``
    frames of the stream that touch the most, at their ground-truth poses,
    none shared, with KF_VOXEL_MARGIN for the estimated poses: no correct
    insert of ``n_integrated`` keyframes fills the table further."""
    most = sorted(voxels_per_frame, reverse=True)[:n_integrated]
    return sum(most) * (1.0 + KF_VOXEL_MARGIN) / capacity


def keyframe_drops(vol, est, cam, left, right, Twc, insert=False):
    """(dropped, valid): the valid voxel updates of one keyframe (all its
    TSDF phases, depth from ``est``) and how many of them the table ``vol``
    drops, i.e. leaves unresolved after the insert's claim rounds.  The
    table is left as it stands, unless ``insert``: then each phase is fused
    into it as the integrator fuses it."""
    from pyslam_tpu_torch.ops import voxel_hash

    dropped = valid = 0
    for upd in keyframe_updates(vol, est, cam, left, right, Twc):
        slot, _ = voxel_hash.claim_slots(vol.table, upd[0], upd[4])
        dropped += int((upd[4] & (slot < 0)).sum())
        valid += int(upd[4].sum())
        if insert:
            vol.table = voxel_hash.insert_and_accumulate(vol.table, *upd)
    return dropped, valid


def dense_phase(dev, ds, cam, left, right):
    """Phase 6: the dense slice on the card against the CPU, and its times."""
    import torch

    from pyslam_tpu_torch.dense.tsdf import TSDFVolume, depth_to_voxel_updates
    from pyslam_tpu_torch.depth_estimation.depth_estimator import DepthEstimatorSgbm
    from pyslam_tpu_torch.ops import voxel_hash

    integ = build_integrator(cam, dev)
    est = integ._depth_provider
    assert isinstance(est, DepthEstimatorSgbm) and est.downscale == 2, est
    est_cpu = DepthEstimatorSgbm(cam, downscale=2, device="cpu")
    disp = est._disparity_full_scale(left, right)
    disp_cpu = est_cpu._disparity_full_scale(left, right)
    assert torch.equal(disp.cpu(), disp_cpu), "SGM disparity differs between card and CPU"
    depth = est.infer_depth_device(left, right)
    depth_cpu = est_cpu.infer_depth_device(left, right)
    assert depth.device == dev and torch.equal(depth.cpu(), depth_cpu), \
        "SGM depth differs between card and CPU"
    valid_share = float((depth > 0).float().mean())
    assert valid_share > 0.2, valid_share
    hs, ws = ds.h // 2, ds.w // 2
    n_disp = max(16, est.max_disparity // 2)
    log(f"[dense] SGM {hs}x{ws}x{n_disp} of the first stereo pair: disparity and depth "
        f"identical on the card and the CPU; {valid_share * 100:.2f}% of the pixels valid")

    # one keyframe's TSDF phases into a 1 << 22 table, card against CPU
    Twc = ds.poses[0]
    vols = [TSDFVolume(voxel_size=VOXEL_SIZE, sdf_trunc=SDF_TRUNC,
                       depth_trunc=DEPTH_TRUNC_OUTDOOR, capacity=TABLE_CAPACITY, device=d)
            for d in (dev, "cpu")]
    for phase in range(TSDF_PHASES):
        vols[0].integrate(depth, left, Twc, cam.K, phase=phase, phases=TSDF_PHASES)
        vols[1].integrate(depth_cpu, left, Twc, cam.K, phase=phase, phases=TSDF_PHASES)
    got, ref = vols[0].table, vols[1].table
    for f in ("keys", "occupied"):
        assert torch.equal(getattr(got, f).cpu(), getattr(ref, f)), f"TSDF {f} differ"
    max_err = {}
    for f in ("tsdf", "weight", "color"):
        a, b = getattr(got, f).cpu(), getattr(ref, f)
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        max_err[f] = float((a - b).abs().max())
    n_vox = vols[0].num_voxels()
    assert n_vox > 0
    log(f"[dense] TSDF {TSDF_PHASES} phases (stride {vols[0].stride}, band "
        f"{vols[0].band_steps}) into a {TABLE_CAPACITY}-slot table: {n_vox} voxels, slots, "
        f"keys and occupied identical on the card and the CPU; max |card - CPU| "
        + ", ".join(f"{k} {v:.3g}" for k, v in max_err.items()))

    # times on the card: SGM a keyframe, one TSDF phase and its parts
    iml = torch.as_tensor(np.asarray(left, np.float32), device=dev)
    imr = torch.as_tensor(np.asarray(right, np.float32), device=dev)
    K = torch.as_tensor(np.asarray(cam.K, np.float32), device=dev)
    T = torch.as_tensor(np.asarray(Twc, np.float32), device=dev)
    inten = iml
    vol = vols[0]
    args = (VOXEL_SIZE, SDF_TRUNC, DEPTH_TRUNC_OUTDOOR, vol.stride, vol.band_steps)

    def sgm():
        return est.infer_depth_device(iml, imr)

    def updates(phase=1):
        return depth_to_voxel_updates(depth, inten, T, K, *args, phase, TSDF_PHASES)

    upd = updates()
    table0 = vol.table

    def insert():
        return voxel_hash.insert_and_accumulate(table0, *upd)

    def tsdf_phase():
        return voxel_hash.insert_and_accumulate(table0, *updates())

    out = {}
    for name, fn in (("sgm", sgm), ("tsdf_phase", tsdf_phase), ("updates", updates),
                     ("insert", insert)):
        fn()
        launches, dev_ms = profile_call(fn)
        out[name] = dict(launches=launches, device_ms=dev_ms, ms=events_ms(fn))
    # bounds: SGM from its shapes; the insert in place, from this phase's
    # updates and the table rows they touch
    # updates: the phase's strided pixels read, its updates written; the
    # phase fused: its pixels read and the rows it touches read and written
    # (no update batch in memory)
    sgm_b = sgm_work(hs, ws, n_disp)
    after = insert()
    touched = int(((after.weight != table0.weight) | (after.occupied != table0.occupied)).sum())
    n_upd = int(upd[0].shape[0])
    n_pix = n_upd // (2 * vol.band_steps + 1)
    out["sgm"].update(sgm_b)
    out["updates"].update(bound(PIXEL_BYTES * n_pix + UPDATE_BYTES * n_upd,
                                OPS_PIXEL * n_pix + OPS_UPDATE * n_upd), pixels=n_pix,
                          updates=n_upd)
    out["insert"].update(bound(UPDATE_BYTES * n_upd + 2 * ROW_BYTES * touched, 0),
                         updates=n_upd, valid_updates=int(upd[4].sum()),
                         touched_slots=touched)
    out["tsdf_phase"].update(bound(PIXEL_BYTES * n_pix + 2 * ROW_BYTES * touched,
                                   OPS_PIXEL * n_pix + OPS_UPDATE * n_upd),
                             parts_bound_ms=out["updates"]["bound_ms"]
                             + out["insert"]["bound_ms"])
    for name, o in out.items():
        log(f"[dense] {name}: {o['launches']} kernel launches, {o['device_ms']:.4f} ms of "
            f"kernel time a call (profiler), {o['ms']:.4f} ms a call over 20 back-to-back "
            f"calls (events)" + (f"; bound {o['bound_ms']:.5f} ms ({o['bound_by']}: "
                                  f"{o['bytes']} B, {o['ops']} operations)"
                                  if "bound_ms" in o else ""))

    # standalone TSDF rate as bench.py:158-177 measures it: whole 376x1241
    # random depths of 4-60 m from host arrays, after one warm-up integrate
    rng = np.random.default_rng(3)
    depths = [rng.uniform(4.0, 60.0, (ds.h, ds.w)).astype(np.float32) for _ in range(3)]
    inten_h = rng.uniform(0, 255, (ds.h, ds.w)).astype(np.float32)
    rate_vol = TSDFVolume(voxel_size=VOXEL_SIZE, sdf_trunc=SDF_TRUNC,
                          depth_trunc=DEPTH_TRUNC_OUTDOOR, capacity=TABLE_CAPACITY, device=dev)
    rate_vol.integrate(depths[0], inten_h, np.eye(4), cam.K)
    n_rate = 10
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(n_rate):
        rate_vol.integrate(depths[i % 3], inten_h, np.eye(4), cam.K)
    end.record()
    torch.cuda.synchronize()
    out["tsdf_rate_per_s"] = n_rate / (start.elapsed_time(end) / 1e3)
    log(f"[dense] standalone TSDF rate (stride {rate_vol.stride}, band "
        f"{rate_vol.band_steps}): {out['tsdf_rate_per_s']:.2f} integrations a second")
    log("[dense] " + json.dumps(out))
    return out


def ate_of(slam, gt_t, gt_p):
    """ATE (m) of the trajectory tracked so far against the ground truth."""
    from pyslam_tpu_torch.evaluation.metrics import eval_ate

    ts, Twc = slam.tracking.history.final_trajectory(slam.map)
    return float(eval_ate(ts, Twc[:, :3, 3], gt_t, gt_p, align=True, with_scale=False).rmse)


def loop_phase(dev, cam_args, frames, loop="DBOW3"):
    """Phase 8 (14c with ``loop="COSPLACE"``, 16d with ``"VLAD"``):
    bench.py's loop stage on the port with the ``loop`` detector; returns
    its numbers.  ``frames`` are the rendered (left, right, timestamp), the
    whole stage or its first frames."""
    import torch

    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.ops import optim
    from pyslam_tpu_torch.ops.fast import fast_nms
    from pyslam_tpu_torch.slam.camera import PinholeCamera
    from pyslam_tpu_torch.slam.slam import Slam

    ds = loop_stream()
    n = len(frames)
    gt_t = np.asarray([ds.getTimestamp(i) for i in range(n)])
    gt_p = ds.poses[:n, :3, 3]
    cam = PinholeCamera(*cam_args, fps=ds.fps, bf=ds.fx * ds.baseline, depth_threshold=35.0)
    tag = "[loop]" if loop == "DBOW3" else f"[{loop.lower()}]"
    slam = Slam(cam, FeatureTrackerConfig(num_features=N_FEATURES, num_levels=N_LEVELS),
                loop_detector_config=loop, sensor_type=SensorType.STEREO, device=dev)
    lc = slam.loop_closing
    events, pgo_args = [], []
    correct = lc.correct_loop
    pgo = optim.pose_graph_optimize

    def correct_loop(kf, cand, S12):
        before = ate_of(slam, gt_t, gt_p)
        correct(kf, cand, S12)
        events.append(dict(kf=kf.kid, cand=cand.kid, S12=S12.copy(),
                           geometry=dict(lc.last_geometry), ate_before=before,
                           ate_after=ate_of(slam, gt_t, gt_p), pgo=lc.last_pgo_size))

    def pose_graph_optimize(*args, **kw):
        pgo_args[:] = [args, kw]
        return pgo(*args, **kw)

    lc.correct_loop = correct_loop
    optim.pose_graph_optimize = pose_graph_optimize
    torch.cuda.synchronize()
    fast_nms.launches = 0
    lats = []
    t_start = time.perf_counter()
    for i, (img_l, img_r, ts) in enumerate(frames):
        nxt = None
        if i + 1 < n:
            nl, nr, nts = frames[i + 1]
            nxt = {"img": nl, "img_right": nr, "frame_id": i + 1, "timestamp": nts}
        n_events = len(events)
        t1 = time.perf_counter()
        slam.track(img_l, img_right=img_r, frame_id=i, timestamp=ts, next_input=nxt)
        lats.append(time.perf_counter() - t1)
        if len(events) > n_events:
            e = events[-1]
            log(f"{tag} frame {i}: loop kf {e['kf']} <-> kf {e['cand']} closed in a "
                f"{lats[-1] * 1e3:.1f} ms frame; geometry {json.dumps(e['geometry'])}; PGO "
                f"{e['pgo'][0]} vertices, {e['pgo'][1]} edges; ATE so far {e['ate_before']:.4f}"
                f" m before the correction, {e['ate_after']:.4f} m after")
        elif i % 25 == 0:
            log(f"{tag} frame {i}: {lats[-1] * 1e3:.1f} ms, {slam.map.num_keyframes()} "
                f"keyframes, {slam.map.num_points()} points")
    slam.finish()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = fast_nms.launches
    lc.correct_loop = correct
    optim.pose_graph_optimize = pgo
    n_tracked = len(slam.tracking.history.timestamps)
    ts_est, poses = slam.get_final_trajectory()
    ate = ate_of(slam, gt_t, gt_p)
    lat_ms = np.asarray(lats[LOOP_SKIP:]) * 1e3
    gba = slam.GBA
    log(f"{tag} {n / wall:.2f} FPS over {n} frames (incl. final drain), "
        f"latency p50 {np.percentile(lat_ms, 50):.1f} ms p95 {np.percentile(lat_ms, 95):.1f} ms"
        f" max {lat_ms.max():.1f} ms (frame {LOOP_SKIP + int(np.argmax(lat_ms))}) over frames "
        f"{LOOP_SKIP}-{n - 1}; {lc.num_loops_closed} loops closed; "
        f"{n_tracked}/{n} tracked; {slam.map.num_keyframes()} keyframes, "
        f"{slam.map.num_points()} points; ATE {ate:.4f} m; GBA {gba.runs_completed} applied, "
        f"{gba.runs_aborted} aborted (cost {gba.last_cost:.3f}); fast_nms launches {launches}")
    log(f"{tag} stage totals (ms, calls): " + json.dumps(
        {mod: {k: [round(v["total_ms"], 1), v["calls"]] for k, v in st.items()}
         for mod, st in slam.timings().items()
         if mod in ("loop_closing", "gba", "local_mapping")}))
    out = dict(loop=loop, launches=launches, n_tracked=n_tracked, ate=ate,
               loops_closed=lc.num_loops_closed, keyframes=slam.map.num_keyframes(),
               frames=n, fps=n / wall, p50_ms=float(np.percentile(lat_ms, 50)),
               p95_ms=float(np.percentile(lat_ms, 95)), gba_applied=gba.runs_completed)
    if loop == "DBOW3":
        assert lc.num_loops_closed >= 1, "no loop closed"
        assert gba.runs_completed >= 1, "no GBA applied"
    assert n_tracked == n, f"{n_tracked}/{n} tracked"
    assert np.isfinite(poses).all() and ate < ATE_MAX, ate
    assert launches == n, f"{launches} fast_nms launches for {n} frames"
    assert slam.map.device.type == "cuda" and slam.map.device_store()[0].device.type == "cuda"
    if lc.detector.score_based:
        out.update(vpr_check(lc, slam))

    # a lost frame relocalised on the card: frame RELOC_FRAME again, its
    # pose pushed 1 m away, against the final map; held to its tracked pose
    from pyslam_tpu_torch.slam.frame import Frame

    img_l, img_r, ts = frames[RELOC_FRAME]
    lost = Frame(cam, img_l, img_right=img_r, timestamp=ts,
                 feature_tracker=slam.feature_tracker, frame_id=10_000)
    Twc_tracked = poses[int(np.argmin(np.abs(ts_est - ts)))]
    push = np.eye(4)
    push[:3, 3] = [1.0, 0.0, 0.5]
    lost.update_pose(push @ np.linalg.inv(Twc_tracked))
    T_rel, ok_rel = lc.relocalizer.relocalize(lost, slam.map)
    err = float(np.linalg.norm(np.linalg.inv(T_rel)[:3, 3] - Twc_tracked[:3, 3]))
    log(f"{tag} frame {RELOC_FRAME} relocalised from a pose 1.1 m off: ok {ok_rel}, "
        f"{int((lost.points >= 0).sum())} points, {err:.4f} m from its tracked pose")
    out.update(reloc_ok=bool(ok_rel), reloc_err_m=err)
    if loop != "DBOW3":
        gba.finish()
        return out
    assert ok_rel and err < 0.3, (ok_rel, err)

    # the loop event's device cost, replayed on the final map (its result
    # is not used further): geometry check, the pose graph (all but ~2 % of
    # the correction's launches), the GBA's dispatch and one chunk
    e = events[0]
    kf, cand = slam.map.keyframes.get(e["kf"]), slam.map.keyframes.get(e["cand"])
    cost = {}
    if kf is not None and cand is not None:
        cost["geometry_check"] = profile_call(lambda: lc.geometry_check(kf, cand))
    args, kw = pgo_args
    cost["pgo"] = profile_call(lambda: pgo(*args, **kw))
    cost["gba_dispatch"] = profile_call(lambda: gba.dispatch(slam.map))
    cost["gba_chunk"] = profile_call(lambda: gba.poll(block=True))
    gba.finish()
    log(f"[loop] loop event on the final map ({slam.map.num_keyframes()} keyframes, "
        f"{slam.map.num_points()} points), kernel launches and summed kernel time (ms, "
        f"torch.profiler): " + json.dumps({k: [n, round(ms, 4)] for k, (n, ms) in cost.items()}))
    return out


def vpr_check(lc, slam):
    """Phase 14c's checks of a score-based detector after its stage: every
    keyframe described (a unit global descriptor, no words) and held in
    the database; the descriptor of one keyframe's img_vpr on the card
    against the CPU (CosPlaceExtractor built there from the same bundled
    weights) within VPR_TOL; the time of one description on the card."""
    import torch

    from pyslam_tpu_torch.models.cosplace import CosPlaceExtractor

    db, net = lc.db, lc.detector.netvlad
    kids = sorted(slam.map.keyframes)
    missing = [k for k in kids if k not in db.kf_gdes]
    assert not missing, f"keyframes not in the database: {missing}"
    vlad = lc.detector.vlad
    if vlad is not None:
        # VLAD (phase 16d): every keyframe re-described once the vocabulary
        # trained (a placeholder fills centre 0's slot only)
        g = np.stack([db.kf_gdes[k] for k in kids])
        d = g.shape[1] // vlad.k
        placeholders = int((np.abs(g[:, d:]).max(1) == 0).sum())
        assert vlad.trained and all(len(db.kf_words[k]) == 0 for k in kids)
        assert np.allclose(np.linalg.norm(g, axis=1), 1.0, atol=1e-4) and placeholders == 0
        log(f"[vlad] {len(kids)} keyframes described ({g.shape[1]}-d, {vlad.k} centres, no "
            f"words), none left with the pre-training placeholder")
        return dict(described=len(kids), db_entries=len(db.kf_gdes), placeholders=placeholders)
    g = np.stack([db.kf_gdes[k] for k in kids])
    assert g.shape == (len(kids), net.out_dim) and all(len(db.kf_words[k]) == 0 for k in kids)
    assert np.allclose(np.linalg.norm(g, axis=1), 1.0, atol=1e-4)
    kf = slam.map.keyframes[kids[len(kids) // 2]]
    assert kf.img_vpr is not None and kf.img_vpr.shape == ((H + 1) // 2, (W + 1) // 2)
    cpu = CosPlaceExtractor(device="cpu")
    assert net.trained and cpu.trained and net.device.type == "cuda"
    err = float(np.abs(net(kf.img_vpr) - cpu(kf.img_vpr)).max())
    canvas = torch.from_numpy(net.prepare(kf.img_vpr)).to(net.device)
    ms = events_ms(lambda: net.describe(canvas))
    log(f"[cosplace] {len(kids)} keyframes described and in the database "
        f"({len(db.kf_gdes)} entries, {net.out_dim}-d, no words); kf {kf.kid}'s img_vpr "
        f"{kf.img_vpr.shape[0]}x{kf.img_vpr.shape[1]} on the {net.image_hw[0]}x"
        f"{net.image_hw[1]} canvas: card against CPU within {err:.3g} (tolerance {VPR_TOL}); "
        f"one description {ms:.3f} ms on the card (CUDA events)")
    assert err <= VPR_TOL, err
    return dict(described=len(kids), db_entries=len(db.kf_gdes), desc_max_abs_err=err,
                describe_ms=ms)


def sensor_stage(dev, sensor, frames, cam, ds, integ=None):
    """Phases 9 and 10: the main stage's stream through Slam.track() as RGBD
    (left image and depth) or monocular (left image), with next-frame
    prefetch, then finish().  Returns the stage's numbers."""
    import torch

    from pyslam_tpu_torch.evaluation.metrics import eval_ate
    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.ops import epipolar
    from pyslam_tpu_torch.ops.fast import fast_nms
    from pyslam_tpu_torch.slam.slam import Slam

    mono = sensor == "MONOCULAR"
    tag = "[mono]" if mono else "[rgbd]"
    slam = Slam(cam, FeatureTrackerConfig(num_features=N_FEATURES, num_levels=N_LEVELS),
                sensor_type=SensorType[sensor], device=dev)
    if integ is not None:
        slam.set_volumetric_integrator(integ)
    # record the initialiser's minimal samples (its default draws), so that
    # the initialising attempt can be replayed and profiled after the stage
    draws = []
    sample = epipolar.generator_sampler(dev, 42)

    def recording_sampler(*args):
        draws.append(sample(*args))
        return draws[-1]

    slam.tracking.initializer.sampler = recording_sampler
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fast_nms.launches = 0
    lats, init_frame, ref_frame, init_samples, t_start = [], None, None, None, None
    n = len(frames)
    for i, (img, depth, ts) in enumerate(frames):
        if i == 10:
            t_start = time.perf_counter()
        nxt = None
        if i + 1 < n:
            nxt = {"img": frames[i + 1][0], "frame_id": i + 1, "timestamp": frames[i + 1][2],
                   "depth": None if mono else frames[i + 1][1]}
        n_hist = len(slam.tracking.history.timestamps)
        t1 = time.perf_counter()
        slam.track(img, depth=None if mono else depth, frame_id=i, timestamp=ts,
                   next_input=nxt)
        lats.append(time.perf_counter() - t1)
        if init_frame is None and len(slam.tracking.history.timestamps) > n_hist:
            init_frame = i
            ref = slam.tracking.initializer.ref_frame
            ref_frame = ref.id if mono and ref is not None else i
            init_samples = draws[-1] if mono else None
            log(f"{tag} frame {i}: map initialised in a {lats[-1] * 1e3:.1f} ms frame, "
                f"{slam.map.num_keyframes()} keyframes, {slam.map.num_points()} points")
        if i % 10 == 0:
            log(f"{tag} frame {i}: {lats[-1] * 1e3:.1f} ms, {slam.map.num_keyframes()} "
                f"keyframes, {slam.map.num_points()} points")
    slam.finish()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    out = dict(launches=fast_nms.launches, init_frame=init_frame, ref_frame=ref_frame,
               peak_mb=torch.cuda.max_memory_allocated() / 2**20,
               n_tracked=len(slam.tracking.history.timestamps),
               keyframes=slam.map.num_keyframes(), points=slam.map.num_points(),
               fps=(n - 10) / wall)
    ts_est, poses = slam.get_final_trajectory()
    gt_t = np.asarray([ds.getTimestamp(i) for i in range(n)])
    out["ate"] = float(eval_ate(ts_est, poses[:, :3, 3], gt_t, ds.poses[:n, :3, 3],
                                align=True, with_scale=mono).rmse)
    lat_ms = np.asarray(lats[10:]) * 1e3
    out["p50_ms"], out["p95_ms"] = np.percentile(lat_ms, 50), np.percentile(lat_ms, 95)
    out["init_frame_ms"] = lats[init_frame] * 1e3 if init_frame is not None else None
    log(f"{tag} {out['fps']:.2f} FPS over frames 10-{n - 1} (incl. final drain), latency "
        f"p50 {out['p50_ms']:.1f} ms p95 {out['p95_ms']:.1f} ms; initialised at frame "
        f"{init_frame}; {out['n_tracked']}/{n} tracked, {out['keyframes']} keyframes, "
        f"{out['points']} points, {slam.local_mapping.lba_applied} local BAs applied, ATE "
        f"{out['ate']:.4f} m{' (similarity alignment)' if mono else ''}; fast_nms launches "
        f"{out['launches']}; peak device memory {out['peak_mb']:.1f} MiB")
    if integ is not None:
        n_vox = integ.volume.num_voxels()
        out.update(snapshots=len(integ.snapshots), integrated=integ.volume.num_integrated,
                   voxels=n_vox, load=n_vox / integ.volume.capacity)
        log(f"{tag} dense (sensor depth, no SGM): {out['snapshots']} keyframes handed over, "
            f"{out['integrated']} integrated, {n_vox} voxels, load factor {out['load']:.4f}")
    log(f"{tag} stage totals: " + json.dumps(
        {mod: {k: round(v["total_ms"], 1) for k, v in st.items()}
         for mod, st in slam.timings().items()}))
    assert slam.map.device.type == "cuda"
    return out, slam, init_samples


def vo_phase(dev, frames, cam, ds):
    """Phase 11: both visual odometries on the stream, each frame timed on
    the host; returns their numbers."""
    import torch

    from pyslam_tpu_torch.evaluation.metrics import eval_ate
    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig, feature_tracker_factory
    from pyslam_tpu_torch.io.ground_truth import groundtruth_factory
    from pyslam_tpu_torch.ops.fast import fast_nms
    from pyslam_tpu_torch.slam.visual_odometry import VisualOdometry
    from pyslam_tpu_torch.slam.visual_odometry_rgbd import VisualOdometryRgbd

    n = len(frames)
    gt = groundtruth_factory({"type": "synthetic", "dataset": ds})
    tracker = feature_tracker_factory(FeatureTrackerConfig(num_features=N_FEATURES,
                                                           num_levels=N_LEVELS), device=dev)
    out = {}
    for name, vo in (("mono", VisualOdometry(cam, tracker, groundtruth=gt)),
                     ("rgbd", VisualOdometryRgbd(cam, num_features=N_FEATURES, device=dev))):
        torch.cuda.synchronize()
        fast_nms.launches = 0
        lats = []
        t0 = time.perf_counter()
        for i, (img, depth, ts) in enumerate(frames):
            t1 = time.perf_counter()
            if name == "mono":
                vo.track(img, i, ts)
            else:
                vo.track(img, depth, i, ts)
            lats.append(time.perf_counter() - t1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ate = float(eval_ate(np.asarray(vo.timestamps), vo.trajectory, gt.timestamps,
                             gt.positions[:n], align=True, with_scale=False).rmse)
        out[name] = dict(launches=fast_nms.launches, fps=n / wall, ate=ate,
                         p50_ms=float(np.percentile(np.asarray(lats[1:]) * 1e3, 50)), vo=vo)
        log(f"[vo] {name}: {out[name]['fps']:.2f} FPS over {n} frames, latency p50 "
            f"{out[name]['p50_ms']:.1f} ms, ATE {ate:.4f} m, fast_nms launches "
            f"{out[name]['launches']}")
    return out, tracker


def card_vs_cpu(dev, frames, cam, tracker):
    """Phase 11's comparisons on one frame pair, card against CPU: the RGBD
    virtual right coordinates, the essential matrix and pose with the same
    minimal samples, LK; and the device cost (launches, kernel ms) of one LK
    call at 2000 points and one find_essential + recover_pose."""
    import torch

    from pyslam_tpu_torch.config_parameters import Parameters
    from pyslam_tpu_torch.ops import epipolar, fast, lk, nms
    from pyslam_tpu_torch.slam.frame import Frame, compute_stereo_from_rgbd
    from pyslam_tpu_torch.utils.padding import pad_bucket, pad_rows

    (img0, depth0, _), (img1, _, _) = frames[0], frames[1]
    f0 = Frame(cam, img0, depth=depth0, feature_tracker=tracker, frame_id=0)
    cpu = torch.device("cpu")
    kps, raw, valid = f0.dev("kps"), torch.as_tensor(f0.kps_raw).to(dev), f0.dev("valid")
    d0 = torch.as_tensor(depth0).to(dev)
    got = compute_stereo_from_rgbd(kps, raw, valid, d0, cam.bf, Parameters.kMinDepth)
    ref = compute_stereo_from_rgbd(kps.to(cpu), raw.to(cpu), valid.to(cpu), d0.to(cpu), cam.bf,
                                   Parameters.kMinDepth)
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b), "compute_stereo_from_rgbd differs on the card"
    log(f"[card-cpu] compute_stereo_from_rgbd identical on the card and the CPU "
        f"({int((got[1] > 0).sum())} keypoints with depth)")

    # the essential matrix of the monocular pair 0 -> 1, the same samples
    fa, fb = tracker.detectAndCompute(img0), tracker.detectAndCompute(img1)
    i1, i2 = tracker.match(fa, fb)
    xa, xb = fa.xy.cpu().numpy()[i1], fb.xy.cpu().numpy()[i2]
    xy1, pvalid = pad_bucket(np.asarray(cam.unproject_points(xa)))
    xy2 = pad_rows(np.asarray(cam.unproject_points(xb)), len(pvalid))
    th2 = (1.0 / cam.fx) ** 2 * 3.84
    samples = epipolar.generator_sampler(cpu, 42)(torch.as_tensor(pvalid), 512, 8)
    res = {}
    for d in (dev, cpu):
        x1, x2 = torch.as_tensor(xy1).to(d), torch.as_tensor(xy2).to(d)
        E, m, nin = epipolar.find_essential(x1, x2, torch.as_tensor(pvalid).to(d), th2, 512,
                                            samples=samples.to(d))
        T, front = epipolar.recover_pose(E, x1, x2, m)
        res[d.type] = (E.cpu().numpy(), m.cpu().numpy(), int(nin), T.cpu().numpy(),
                       front.cpu().numpy())
    (Eg, mg, ng, Tg, _), (Ec, mc, nc, Tc, _) = res["cuda"], res["cpu"]
    rot = float(np.arccos(np.clip((np.trace(Tg[:3, :3].T @ Tc[:3, :3]) - 1) / 2, -1, 1)))
    tdir = float(np.linalg.norm(Tg[:3, 3] / np.linalg.norm(Tg[:3, 3])
                                - Tc[:3, 3] / np.linalg.norm(Tc[:3, 3])))
    # recover_pose of the same E on both
    x1g, x2g = torch.as_tensor(xy1).to(dev), torch.as_tensor(xy2).to(dev)
    Tsame, fsame = epipolar.recover_pose(torch.as_tensor(Ec).to(dev), x1g, x2g,
                                         torch.as_tensor(mc).to(dev))
    Tsame = Tsame.cpu().numpy()
    rot_same = float(np.arccos(np.clip((np.trace(Tsame[:3, :3].T @ Tc[:3, :3]) - 1) / 2,
                                       -1, 1)))
    log(f"[card-cpu] find_essential + recover_pose on {len(i1)} matches of frames 0-1, the "
        f"same 512 minimal samples: inliers {ng} on the card, {nc} on the CPU; rotation "
        f"{rot:.3e} rad and unit translation {tdir:.3e} apart; recover_pose of the CPU's E "
        f"on the card: rotation {rot_same:.3e} rad apart, in-front mask "
        f"{'identical' if np.array_equal(fsame.cpu().numpy(), res['cpu'][4]) else 'differs'}")
    # per hypothesis: the solvers take AᵀA's null vector in float32, which
    # is float32 noise where λ2 / λmax <= 1e-5 (float64); count how many of
    # the 512 hypotheses are above that line and how their inlier counts
    # compare (reported: on this forward-moving pair nearly none are)
    counts = {}
    for d in (dev, cpu):
        x1, x2 = torch.as_tensor(xy1).to(d), torch.as_tensor(xy2).to(d)
        Es = epipolar._eight_point(x1[samples.to(d)], x2[samples.to(d)])
        counts[d.type] = torch.sum((epipolar._sampson_error(Es, x1, x2) < th2)
                                   & torch.as_tensor(pvalid).to(d)[None], 1).cpu().numpy()
    A = epipolar._epipolar_rows(torch.as_tensor(xy1).double()[samples],
                                torch.as_tensor(xy2).double()[samples])
    lam = torch.linalg.eigvalsh(A.transpose(-1, -2) @ A).numpy()
    good = lam[:, 1] / lam[:, -1] > 1e-5
    hyp_diff = int(np.abs(counts["cuda"] - counts["cpu"])[good].max()) if good.any() else None
    n_same = int((counts["cuda"] == counts["cpu"]).sum())
    log(f"[card-cpu] hypotheses: {int(good.sum())} of 512 well-conditioned (their inlier "
        f"counts at most {hyp_diff} apart); {n_same} of 512 with identical inlier counts")
    assert abs(ng - nc) <= 0.1 * len(i1) and rot <= 2e-2 and tdir <= 0.3, (ng, nc, rot, tdir)
    assert rot_same <= 1e-3, rot_same

    # LK of the RGBD VO's corners, 2000 at most, frame 0 -> 1
    score = fast.fast_nms(torch.as_tensor(img0)[None].to(dev), VO_FAST_TH)
    xy, _, v = nms.grid_topk_keypoints(score, 16, 6, N_FEATURES)
    pts = xy[0][v[0]].cpu().numpy()
    ptsp, _ = pad_bucket(pts.astype(np.float32))
    out = {}
    for d in (dev, cpu):
        p, ok, _ = lk.lk_track_pyramidal(torch.as_tensor(img0).to(d), torch.as_tensor(img1).to(d),
                                         torch.as_tensor(ptsp).to(d))
        out[d.type] = (p.cpu().numpy(), ok.cpu().numpy())
    both = out["cuda"][1] & out["cpu"][1]
    lk_err = float(np.abs(out["cuda"][0][both] - out["cpu"][0][both]).max())
    n_ok_diff = int((out["cuda"][1] != out["cpu"][1]).sum())
    log(f"[card-cpu] LK of {len(pts)} corners (padded to {len(ptsp)}): {int(both.sum())} ok on "
        f"both, max |card - CPU| {lk_err:.3e} px, ok masks differ on {n_ok_diff}")
    assert lk_err <= 1e-2, lk_err

    # device cost of one LK call and one essential matrix + pose
    i0t, i1t = torch.as_tensor(img0).to(dev), torch.as_tensor(img1).to(dev)
    pt = torch.as_tensor(ptsp).to(dev)
    vt = torch.as_tensor(pvalid).to(dev)
    st = samples.to(dev)

    def essential():
        E, m, _ = epipolar.find_essential(x1g, x2g, vt, th2, 512, samples=st)
        return epipolar.recover_pose(E, x1g, x2g, m)

    cost = {"lk_track_pyramidal": profile_call(lambda: lk.lk_track_pyramidal(i0t, i1t, pt)),
            "find_essential_recover_pose": profile_call(essential)}
    cost_ms = {"lk_track_pyramidal": events_ms(lambda: lk.lk_track_pyramidal(i0t, i1t, pt), 5),
               "find_essential_recover_pose": events_ms(essential, 5)}
    log(f"[cost] kernel launches and summed kernel time (ms, torch.profiler), and the time "
        f"of one call (ms, CUDA events over 5 calls): LK at {len(ptsp)} points "
        f"{cost['lk_track_pyramidal']}, {cost_ms['lk_track_pyramidal']:.3f} ms; "
        f"find_essential + recover_pose at {len(pvalid)} rows "
        f"{cost['find_essential_recover_pose']}, "
        f"{cost_ms['find_essential_recover_pose']:.3f} ms")
    return dict(lk_err=lk_err, rot=rot, tdir=tdir, rot_same_E=rot_same,
                hyp_well_conditioned=int(good.sum()), hyp_diff=hyp_diff,
                hyp_identical=n_same, inliers=(ng, nc), cost=cost, cost_ms=cost_ms)


def mono_init_cost(dev, frames, cam, tracker, ref_id, init_id, samples):
    """Launches and kernel ms of the monocular initialisation of phase 10,
    replayed: frame ref_id as the reference, frame init_id's attempt
    profiled with the minimal samples that attempt drew in the stage."""
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.slam.frame import Frame
    from pyslam_tpu_torch.slam.initializer import Initializer
    from pyslam_tpu_torch.slam.map import Map

    fr = Frame(cam, frames[ref_id][0], feature_tracker=tracker, frame_id=ref_id)
    fi = Frame(cam, frames[init_id][0], feature_tracker=tracker, frame_id=init_id)
    init = Initializer(SensorType.MONOCULAR, N_FEATURES, device=dev,
                       sampler=lambda *args: samples)
    m = Map(device=dev)
    init.initialize(fr, m)
    result = []
    cost = profile_call(lambda: result.append(init.initialize(fi, m).success))
    log(f"[cost] the monocular initialisation of phase 10 replayed (reference frame "
        f"{ref_id}, frame {init_id}, its minimal samples): {cost[0]} kernel launches, "
        f"{cost[1]:.4f} ms of kernel time; success {result[0]}")
    return cost


def one_image_kernels(dev, frames):
    """The kernel as the monocular and RGBD paths call it, against its
    plain version, bit for bit, and timed: the B = 1 pyramid (8 levels of
    one 376x1241 image at threshold 20) and the RGBD VO's one level at
    threshold 15."""
    import torch

    from pyslam_tpu_torch.ops import image as image_ops
    from pyslam_tpu_torch.ops.fast import fast_nms, fast_nms_plain, fast_nms_pyramid

    img = torch.as_tensor(frames[0][0])[None].to(dev)
    levels = [x.contiguous() for x in image_ops.build_pyramid(img, N_LEVELS, 1.2)]
    out = {}
    for name, fn, plain, lv, th in (
            ("b1_pyramid", lambda: fast_nms_pyramid(levels, FAST_TH),
             lambda: [fast_nms_plain(x, FAST_TH) for x in levels], levels, FAST_TH),
            ("vo_level_th15", lambda: [fast_nms(img, VO_FAST_TH)],
             lambda: [fast_nms_plain(img, VO_FAST_TH)], [img], VO_FAST_TH)):
        got, ref = fn(), plain()
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert torch.equal(a, b), f"fast_nms differs from the plain version ({name})"
        work = fast_work(lv, th, BORDER)
        out[name] = dict(ms=statistics.median([graph_ms(fn), graph_ms(fn)]),
                         plain_ms=median_ms(plain, n=10), bound_ms=work["bound_ms"],
                         bound_by=work["bound_by"], max_abs_err=max(
                             float((a - b).abs().max()) for a, b in zip(got, ref)))
        log(f"[kernel] fast_nms {name}: equal to the plain version; {out[name]['ms']:.4f} ms "
            f"(CUDA-graph replays), plain {out[name]['plain_ms']:.4f} ms, bound "
            f"{work['bound_ms']:.5f} ms ({work['bound_by']}), "
            f"{work['bound_ms'] / out[name]['ms'] * 100:.1f}% of it")
    return out


def preset_session(dev, preset, frames, cam, ds, loop=None):
    """Phase 12: a stereo session of ``preset`` (at the preset's own width)
    with the ``loop`` detector, next-frame prefetch, then finish(); the
    descriptor gates that Slam writes into Parameters are restored.
    Returns the session's numbers."""
    import torch

    from pyslam_tpu_torch.config_parameters import Parameters
    from pyslam_tpu_torch.evaluation.metrics import eval_ate
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.ops.fast import fast_nms
    from pyslam_tpu_torch.slam.slam import Slam

    gates = {k: getattr(Parameters, k) for k in ("kMaxDescriptorDistance",
                                                 "kMaxOrbDistanceSearchByReproj")}
    tag = f"[features] {preset}"
    try:
        slam = Slam(cam, preset, loop_detector_config=loop, sensor_type=SensorType.STEREO,
                    device=dev)
        resets = []
        reset = slam.reset

        def counted_reset():
            resets.append(i)
            reset()

        slam.reset = counted_reset
        # the device of every frame's descriptors, as the tracker hands them over
        desc_devices = []
        tracker = slam.feature_tracker

        def recorded(fn):
            def call(*args, **kw):
                out = fn(*args, **kw)
                fd = out if hasattr(out, "desc") else out[0]    # FeatureData or (fd, ur, z)
                desc_devices.append(fd.desc.device.type)
                return out
            return call

        tracker.detectAndCompute = recorded(tracker.detectAndCompute)
        if hasattr(tracker.extractor, "extract_stereo"):
            tracker.extractor.extract_stereo = recorded(tracker.extractor.extract_stereo)
        torch.cuda.synchronize()
        fast_nms.launches = 0
        lats, t_start, n = [], None, len(frames)
        skip = min(10, n - 1)    # the first frames warm up
        for i, (img_l, img_r, ts) in enumerate(frames):
            if i == skip:
                t_start = time.perf_counter()
            nxt = None
            if i + 1 < n:
                nl, nr, nts = frames[i + 1]
                nxt = {"img": nl, "img_right": nr, "frame_id": i + 1, "timestamp": nts}
            t1 = time.perf_counter()
            slam.track(img_l, img_right=img_r, frame_id=i, timestamp=ts, next_input=nxt)
            lats.append(time.perf_counter() - t1)
            if i % 10 == 0:
                log(f"{tag} frame {i}: {lats[-1] * 1e3:.1f} ms, {slam.map.num_keyframes()} "
                    f"keyframes, {slam.map.num_points()} points")
        slam.finish()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        ts_est, poses = slam.get_final_trajectory()
        gt_t = np.asarray([ds.getTimestamp(i) for i in range(n)])
        lat_ms = np.asarray(lats[skip:]) * 1e3
        out = dict(preset=preset, loop=loop, launches=fast_nms.launches, resets=len(resets),
                   n_tracked=len(slam.tracking.history.timestamps),
                   keyframes=slam.map.num_keyframes(), points=slam.map.num_points(),
                   desc=f"{slam.map.points.desc.shape[1]}x{slam.map.points.desc.dtype}",
                   desc_devices=sorted(set(desc_devices)), described=len(desc_devices),
                   fps=(n - skip) / wall, p50_ms=float(np.percentile(lat_ms, 50)),
                   p95_ms=float(np.percentile(lat_ms, 95)),
                   ate=(float(eval_ate(ts_est, poses[:, :3, 3], gt_t, ds.poses[:n, :3, 3],
                                       align=True, with_scale=False).rmse)
                        if len(ts_est) >= 3 else float("nan")))
        assert slam.map.device.type == torch.device(dev).type
        log(f"{tag} loop={loop}: {out['fps']:.2f} FPS over frames {skip}-{n - 1} (incl. final "
            f"drain), latency p50 {out['p50_ms']:.1f} ms p95 {out['p95_ms']:.1f} ms; "
            f"{out['n_tracked']}/{n} tracked, {out['resets']} resets, {out['keyframes']} "
            f"keyframes, {out['points']} points ({out['desc']} descriptors), ATE "
            f"{out['ate']:.4f} m; fast_nms launches {out['launches']}")
        log(f"{tag} stage totals: " + json.dumps(
            {mod: {k: round(v["total_ms"], 1) for k, v in st.items()}
             for mod, st in slam.timings().items()}))
        del slam
        torch.cuda.empty_cache()
        return out
    finally:
        for k, v in gates.items():
            setattr(Parameters, k, v)


def kaze_card_vs_cpu(dev, frames):
    """Phase 12c: KAZE on frames 0-1, card against CPU: keypoints,
    descriptors, the L2 brute-force matches and the float flat
    vocabulary's words."""
    import torch

    from pyslam_tpu_torch.features.tracker import feature_tracker_factory
    from pyslam_tpu_torch.loop_closing.vocabulary import BinaryVocabulary

    trackers = [feature_tracker_factory("KAZE", device=d) for d in (dev, "cpu")]
    feats = [[tr.detectAndCompute(frames[i][0]) for i in (0, 1)] for tr in trackers]
    torch.cuda.synchronize()
    g0, c0 = [[x.cpu().numpy() for x in f[0]] for f in feats]
    names = feats[0][0]._fields
    for name in ("xy", "valid", "level", "response", "size"):
        a, b = g0[names.index(name)], c0[names.index(name)]
        assert np.array_equal(a, b), f"KAZE {name} differs on the card"
    desc_err = float(np.abs(g0[names.index("desc")] - c0[names.index("desc")]).max())
    ang = np.abs((g0[names.index("angle")] - c0[names.index("angle")] + 180.0) % 360.0 - 180.0)
    assert desc_err <= KAZE_DESC_TOL, desc_err
    matches = [tr.match(f[0], f[1]) for tr, f in zip(trackers, feats)]
    for a, b in zip(matches[0], matches[1]):
        assert np.array_equal(a, b), "KAZE L2 matches differ on the card"
    # the flat float vocabulary of DBOW3_INDEPENDENT on each device, seeded
    # and trained from the same host descriptors, quantising each device's
    seed = c0[names.index("desc")][c0[names.index("valid")]]
    both = np.concatenate([f.desc[f.valid].cpu().numpy() for f in feats[1]])
    vocs = [BinaryVocabulary(num_words=4096, device=d) for d in (dev, "cpu")]
    words = []
    for voc, f in zip(vocs, feats):
        voc.seed_from_descriptors(seed)
        voc.train_kmeans(both)
        words.append([voc.words_for(x.desc, x.valid) for x in f])
    cent_err = float(np.abs(vocs[0].words_bits - vocs[1].words_bits).max())
    for a, b in zip(words[0], words[1]):
        assert np.array_equal(a, b), "float vocabulary words differ on the card"
    out = dict(keypoints=int(g0[names.index("valid")].sum()), desc_max_abs_err=desc_err,
               angle_max_deg=float(ang.max()), matches=int(len(matches[0][0])),
               centroid_max_abs_err=cent_err,
               distinct_words=int(len(np.unique(np.concatenate(words[0])))))
    log(f"[features] KAZE card against CPU, frames 0-1: {out['keypoints']} keypoints, xy / "
        f"valid / level / response / size identical; descriptors within {desc_err:.3g} "
        f"(tolerance {KAZE_DESC_TOL}), angles within {out['angle_max_deg']:.3g} deg; "
        f"{out['matches']} L2 brute-force matches identical; the float vocabulary's "
        f"centroids within {cent_err:.3g}, words of both frames identical "
        f"({out['distinct_words']} distinct)")
    return out


def presets_on_card(dev, img):
    """Every weight-free preset built on the card through the factory, each
    extracting ``img``: valid keypoints and descriptor layout by preset."""
    import torch

    from pyslam_tpu_torch.features.tracker import WEIGHT_FREE_PRESETS, feature_tracker_factory

    out = {}
    for name in WEIGHT_FREE_PRESETS:
        if name in ("SIFT", "ROOT_SIFT"):
            try:
                import cv2  # noqa: F401
            except ImportError:
                continue
        fd = feature_tracker_factory(name, device=dev).detectAndCompute(img)
        assert fd.desc.device.type == fd.xy.device.type == torch.device(dev).type, name
        out[name] = f"{int(fd.valid.sum())} x {fd.desc.shape[1]} {str(fd.desc.dtype)[6:]}"
    log("[features] every weight-free preset built on the card, frame 0 extracted "
        "(valid keypoints x descriptor layout): " + json.dumps(out))
    return out


def features_phase(dev, frames, cam, ds):
    """Phase 12: the weight-free presets' sessions; returns their numbers."""
    out = {"sessions": [], "presets": presets_on_card(dev, frames[0][0])}
    beblid = preset_session(dev, "ORB2_BEBLID", frames, cam, ds, loop="DBOW3_INDEPENDENT")
    n = len(frames)
    assert beblid["launches"] == n, f"{beblid['launches']} fast_nms launches for {n} frames"
    assert beblid["n_tracked"] == n, f"ORB2_BEBLID {beblid['n_tracked']}/{n} tracked"
    assert beblid["ate"] < FEATURE_ATE_MAX and beblid["desc"] == "512xint8", beblid
    out["ORB2_BEBLID"] = beblid
    out["sessions"].append("ORB2_BEBLID+DBOW3_INDEPENDENT")
    try:
        import cv2  # noqa: F401
        has_cv2 = True
    except ImportError:
        has_cv2 = False
    out["cv2"] = has_cv2
    if has_cv2:
        sift = preset_session(dev, "ROOT_SIFT", frames, cam, ds, loop="DBOW3_INDEPENDENT")
        assert sift["n_tracked"] == n, f"ROOT_SIFT {sift['n_tracked']}/{n} tracked"
        assert sift["ate"] < FEATURE_ATE_MAX and sift["desc"] == "128xfloat32", sift
        out["ROOT_SIFT"] = sift
        out["sessions"].append("ROOT_SIFT+DBOW3_INDEPENDENT")
    else:
        print("[features] cv2 not importable: ROOT_SIFT session not run", flush=True)
    out["kaze_card_vs_cpu"] = kaze_card_vs_cpu(dev, frames)
    out["sessions"].append("KAZE card-vs-CPU")
    kaze = preset_session(dev, "KAZE", frames[:KAZE_FRAMES], cam, ds)
    assert kaze["desc"] in ("64xfloat32", "256xint8"), kaze
    out["KAZE"] = kaze
    out["sessions"].append("KAZE")
    log(f"[features] KAZE {KAZE_FRAMES} frames on the card: {kaze['n_tracked']} tracked, "
        f"{kaze['resets']} resets; the JAX package on the CPU: {WITNESS_KAZE[0]} tracked, "
        f"{WITNESS_KAZE[1]} resets")
    return out


def layer_flops(nets, run):
    """Floating-point operations (a multiply-add as two) of what ``run()``
    computes in the layers of ``nets``, from the layer shapes of one pass:
    every Conv2d and Linear, a deformable conv's contraction and bilinear
    taps, and the SDDH head's four products and taps (counted by hand: they
    are gathers and matrix products, not layers)."""
    import torch

    from pyslam_tpu_torch.models.aliked import SDDH, DeformConv

    flops = []

    def hook(mod, inp, out):
        if isinstance(mod, DeformConv):
            taps, c = mod.k * mod.k, inp[0].shape[1]
            hw = out.shape[2] * out.shape[3]
            # the contraction, its bias, and 9 operations a bilinear tap value
            flops.append(2 * taps * c * out.numel() + out.numel() + BILINEAR_OPS * taps * c * hw)
        elif isinstance(mod, SDDH):
            n, (k, m, dim) = inp[1].shape[0], (mod.cfg.K, mod.cfg.M, mod.cfg.dim)
            flops.append(2 * n * (k * k * dim * 2 * m + 2 * m * 2 * m + 2 * m * dim * dim)
                         + BILINEAR_OPS * n * (k * k + m) * dim)
        elif isinstance(mod, torch.nn.ConvTranspose2d):
            # every input value times its Cout * kh * kw taps
            flops.append(2 * inp[0].numel() * mod.weight[0].numel()
                         + (out.numel() if mod.bias is not None else 0))
        else:
            k = mod.weight[0].numel()      # Cin / groups * kh * kw, or in_features
            flops.append(2 * k * out.numel() + (out.numel() if mod.bias is not None else 0))

    kinds = (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear, DeformConv, SDDH)
    # a DeformConv's ``conv`` holds its weights only: its own hook counts it
    weights_only = {id(m.conv) for net in nets for m in net.modules()
                    if isinstance(m, DeformConv)}
    hooks = [m.register_forward_hook(hook) for net in nets for m in net.modules()
             if isinstance(m, kinds) and id(m) not in weights_only]
    with torch.no_grad():
        run()
    for h in hooks:
        h.remove()
    return sum(flops)


def conv_flops(net, x):
    """Floating-point operations of net(x)'s layers (see ``layer_flops``)."""
    return layer_flops([net], lambda: net(x))


def superpoint_phase(dev, frames, cam, ds):
    """Phase 14a: SuperPoint card against CPU on frames 0-1, its forward
    time, then the SUPERPOINT + DBOW3_INDEPENDENT stereo session; returns
    its numbers."""
    import torch

    from pyslam_tpu_torch.features.orb2 import FeatureData
    from pyslam_tpu_torch.models.superpoint import _INV_255, SuperPointExtractor
    from pyslam_tpu_torch.ops import image as image_ops

    ex = [SuperPointExtractor(num_features=SP_FEATURES, device=d) for d in (dev, "cpu")]
    assert all(e.trained for e in ex), "SuperPoint without its bundled weights"
    prob_err = desc_err = diff_resp = 0.0
    n_same = n_total = n_valid = 0
    for i in (0, 1):
        img = frames[i][0]
        (pg, _), (pc, _) = [e.maps(image_ops.gray_image(img, e.device)) for e in ex]
        prob_err = max(prob_err, float((pg.cpu() - pc).abs().max()))
        fg, fc = [[x.cpu().numpy() for x in e(img)] for e in ex]
        g, c = dict(zip(FeatureData._fields, fg)), dict(zip(FeatureData._fields, fc))
        same = np.all(g["xy"] == c["xy"], 1) & (g["valid"] == c["valid"])
        n_same += int(same.sum())
        n_total += len(same)
        n_valid += int(c["valid"].sum())
        if (~same).any():
            diff_resp = max(diff_resp, float(np.abs(g["response"] - c["response"])[~same].max()))
        shared = same & c["valid"]
        desc_err = max(desc_err, float(np.abs(g["desc"] - c["desc"])[shared].max()))
    share = n_same / n_total
    log(f"[superpoint] card against CPU, frames 0-1 ({H}x{W} cropped to {H // 8 * 8}x"
        f"{W // 8 * 8}): probability map within {prob_err:.3g} (tolerance {SP_TOL}); "
        f"{share * 100:.2f}% of {n_total} keypoint slots identical ({n_valid} valid on the "
        f"CPU), the others at responses within {diff_resp:.3g}; descriptors within "
        f"{desc_err:.3g}")
    assert prob_err <= SP_TOL and share >= 0.99 and diff_resp <= SP_TOL, \
        (prob_err, share, diff_resp)
    assert desc_err <= SP_TOL, desc_err

    # the forward pass and the whole extraction on one image, on the card
    img_t = image_ops.gray_image(frames[0][0], dev)
    x = img_t[None, None, : H // 8 * 8, : W // 8 * 8] * _INV_255
    net = ex[0].net
    flops = conv_flops(net, x)
    with torch.no_grad():
        fwd_ms = events_ms(lambda: net(x))
    ext_ms = events_ms(lambda: ex[0].extract(img_t))
    share_peak = flops / (fwd_ms * 1e-3) / PEAK_FP32_FLOPS
    log(f"[superpoint] one {H // 8 * 8}x{W // 8 * 8} image on the card: forward {fwd_ms:.3f} ms, "
        f"extraction with the decoding {ext_ms:.3f} ms (CUDA events, back-to-back calls); "
        f"{flops / 1e9:.2f} GFLOP of convolutions (from the layer shapes), "
        f"{share_peak * 100:.1f}% of the float32 peak of 67 TFLOP/s (TF32 off)")
    del ex
    torch.cuda.empty_cache()

    sess = preset_session(dev, "SUPERPOINT", frames, cam, ds, loop="DBOW3_INDEPENDENT")
    n = len(frames)
    log(f"[superpoint] SUPERPOINT + DBOW3_INDEPENDENT {n} frames on the card: "
        f"{sess['n_tracked']} tracked, {sess['resets']} resets, ATE {sess['ate']:.4f} m; the JAX "
        f"package on the CPU: {WITNESS_SP[0]} tracked, {WITNESS_SP[1]} resets, ATE "
        f"{WITNESS_SP[2]} m")
    assert sess["desc"] == "256xfloat32", sess
    assert sess["launches"] == 0, f"{sess['launches']} fast_nms launches on the SuperPoint path"
    assert sess["n_tracked"] >= WITNESS_SP[0] - SP_TRACK_MARGIN, sess
    return dict(card_vs_cpu=dict(prob_max_abs_err=prob_err, keypoints_identical=share,
                                 diff_resp=diff_resp, desc_max_abs_err=desc_err),
                forward_ms=fwd_ms, extract_ms=ext_ms, gflop=flops / 1e9,
                fp32_peak_share=share_peak, session=sess)


def lightglue_vo_phase(dev, frames, cam, ds, preset="LIGHTGLUE"):
    """Phase 14b (15c with XFEAT_LIGHTGLUE): VisualOdometry with the
    ``preset`` on phase 11's frames, then LightGlue card against CPU on
    frames 0-1; returns its numbers.  LIGHTGLUE has the bundled weights and
    is held to the JAX package's ATE; the other presets' matchers draw
    seeded random weights."""
    import torch

    from pyslam_tpu_torch.evaluation.metrics import eval_ate
    from pyslam_tpu_torch.features.tracker import feature_tracker_factory
    from pyslam_tpu_torch.io.ground_truth import groundtruth_factory
    from pyslam_tpu_torch.ops.fast import fast_nms
    from pyslam_tpu_torch.slam.visual_odometry import VisualOdometry

    n = len(frames)
    gt = groundtruth_factory({"type": "synthetic", "dataset": ds})
    bundled = preset == "LIGHTGLUE"
    tag = "[lightglue]" if bundled else f"[learned] {preset}"
    tracker = feature_tracker_factory(preset, device=dev)
    glue = tracker.matcher.glue
    assert tracker.trained == bundled, f"{preset}: trained {tracker.trained}"
    vo = VisualOdometry(cam, tracker, groundtruth=gt)
    lats, matches = [], 0
    torch.cuda.synchronize()
    fast_nms.launches = 0
    t0 = time.perf_counter()
    for i, (img, _, ts) in enumerate(frames):
        t1 = time.perf_counter()
        vo.track(img, i, ts)
        lats.append(time.perf_counter() - t1)
        matches += vo.num_matches
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ate = float(eval_ate(np.asarray(vo.timestamps), vo.trajectory, gt.timestamps,
                         gt.positions[:n], align=True, with_scale=False).rmse)
    out = dict(fps=n / wall, p50_ms=float(np.percentile(np.asarray(lats[1:]) * 1e3, 50)),
               ate=ate, matches=matches, launches=fast_nms.launches)
    log(f"{tag} VO {out['fps']:.2f} FPS over {n} frames, latency p50 {out['p50_ms']:.1f} ms, "
        f"{matches} matches in all, ATE {ate:.4f} m" + (
            f"; the JAX package on the CPU: ATE {WITNESS_VO_LG_ATE} m (no matches)" if bundled
            else f" (LightGlue on {glue.net.input_dim}-d descriptors, random weights)"))

    # card against CPU on frames 0-1: the CPU's SuperPoint features matched
    # by the network on each device
    cpu = feature_tracker_factory(preset, device="cpu")
    f0, f1 = [cpu.detectAndCompute(frames[i][0]) for i in (0, 1)]
    s_cpu = cpu.matcher.glue.scores(f0, f1)
    s_card = glue.scores(f0, f1).cpu()
    pair_ok = f0.valid[:, None] & f1.valid[None, :]
    err = float((s_card - s_cpu).abs()[pair_ok].max())
    # the random-weight matchers' log-assignments reach tens in magnitude:
    # they are held relative to the largest, as phase 15a holds its maps
    rel = err / max(float(s_cpu.abs()[pair_ok].max()), 1e-30)
    idx_c, _ = cpu.matcher.glue.match(f0, f1)
    idx_g, _ = glue.match(f0, f1)
    differ = float((idx_g.cpu() != idx_c).double().mean())
    g0, g1 = [type(f)(*[x.to(dev) for x in f]) for f in (f0, f1)]
    ms = events_ms(lambda: glue.scores(g0, g1))
    log(f"{tag} card against CPU, frames 0-1 ({int(f0.valid.sum())} x "
        f"{int(f1.valid.sum())} valid keypoints): log-assignment scores of the valid pairs "
        f"within {err:.3g} ({rel:.3g} of the largest; tolerance {LG_TOL}"
        f"{'' if bundled else ' relative'}), {differ * 100:.2f}% of the match indices "
        f"differ ({int((idx_c >= 0).sum())} matches on the CPU); the network {ms:.3f} ms on "
        f"the card (CUDA events)")
    assert (err if bundled else rel) <= LG_TOL and differ <= 0.01, (err, rel, differ)
    assert np.isfinite(vo.trajectory).all() and vo.trajectory.shape[0] == n, preset
    if bundled:
        assert ate <= WITNESS_VO_LG_ATE + VO_LG_ATE_TOL, ate
    out["scores_rel_err"] = rel
    out.update(scores_max_abs_err=err, indices_differ=differ, network_ms=ms)
    return out


def _nets(ex):
    """The networks an extractor runs (its descriptor stage's too)."""
    import torch

    nets = [v for v in vars(ex).values() if isinstance(v, torch.nn.Module)]
    if hasattr(ex, "descriptor"):
        nets += _nets(ex.descriptor)
    return nets


def _features_card_vs_cpu(fg, fc, xy_tol=0.0):
    """Card and CPU FeatureData: (share of identical keypoint slots, share of
    the CPU's valid keypoints among the card's, the largest response gap of
    the slots that differ, descriptor error on the shared valid slots,
    descriptors finite, valid slots on the CPU).  A slot is identical when
    its valid flag is and its keypoint is within ``xy_tol`` px (0 but for a
    sub-pixel refinement)."""
    from pyslam_tpu_torch.features.orb2 import FeatureData

    g = dict(zip(FeatureData._fields, [x.cpu().numpy() for x in fg]))
    c = dict(zip(FeatureData._fields, [x.cpu().numpy() for x in fc]))
    same = (np.abs(g["xy"] - c["xy"]).max(1) <= xy_tol) & (g["valid"] == c["valid"])
    diff_resp = float(np.abs(g["response"] - c["response"])[~same].max()) if (~same).any() \
        else 0.0
    # each CPU keypoint's nearest card keypoint (by brute force)
    gv, cv = g["xy"][g["valid"]], c["xy"][c["valid"]]
    near = np.full(len(cv), np.inf)
    for i in range(0, len(cv), 512):
        d = np.abs(cv[i:i + 512, None, :] - gv[None, :, :]).max(-1)
        near[i:i + 512] = d.min(1) if gv.size else np.inf
    in_set = float((near <= xy_tol).mean()) if len(cv) else 1.0
    shared = same & c["valid"]
    desc_err = float(np.abs(g["desc"] - c["desc"])[shared].max()) if shared.any() else 0.0
    return (float(same.mean()), in_set, diff_resp, desc_err,
            bool(np.isfinite(g["desc"]).all()), int(c["valid"].sum()))


def _map_err(mg, mc):
    """The largest card-CPU gap of each map over its largest magnitude."""
    return max(float((mg[k].cpu() - mc[k]).abs().max() / max(float(mc[k].abs().max()), 1e-30))
               for k in mc)


def _model_row(name, ex_card, ex_cpu, prep, width, run_maps, run_extract, xy_tol=0.0):
    """One model of phase 15a: card against CPU, then its times on the
    card; ``run_maps(ex, x)`` is its network, ``run_extract(ex, x)`` the
    FeatureData (or descriptors) of the whole extraction."""
    import torch

    torch.set_grad_enabled(False)
    xg, xc = prep("card"), prep("cpu")
    map_err = _map_err(run_maps(ex_card, xg), run_maps(ex_cpu, xc))
    fg, fc = run_extract(ex_card, xg), run_extract(ex_cpu, xc)
    resp = ""
    if isinstance(fg, torch.Tensor):      # a descriptor stage: (N, D) descriptors
        share = in_set = 1.0
        diff_resp, valid = 0.0, int(fc.shape[0])
        desc_err = float((fg.cpu() - fc).abs().max())
        finite, shape = bool(torch.isfinite(fg).all()), tuple(fg.shape)
        desc_dev = fg.device.type
    else:
        share, in_set, diff_resp, desc_err, finite, valid = _features_card_vs_cpu(fg, fc, xy_tol)
        shape, desc_dev = tuple(fg.desc.shape), fg.desc.device.type
        r = fc.response[fc.valid]
        resp = f", responses {float(r.min()):.7g}-{float(r.max()):.7g}" if len(r) else ""
    flops = layer_flops(_nets(ex_card), lambda: run_maps(ex_card, xg))
    fwd_ms = events_ms(lambda: run_maps(ex_card, xg), n=10)
    ext_ms = events_ms(lambda: run_extract(ex_card, xg), n=10)
    ext_flops = layer_flops(_nets(ex_card), lambda: run_extract(ex_card, xg))
    torch.set_grad_enabled(True)
    trained = bool(getattr(ex_card, "trained", False))
    row = dict(map_rel_err=map_err, slots_identical=share, keypoints_in_set=in_set,
               diff_resp=diff_resp,
               desc_max_abs_err=desc_err, desc=f"{shape[0]}x{shape[1]}", valid_cpu=valid,
               trained=trained, forward_ms=fwd_ms, extract_ms=ext_ms, gflop=flops / 1e9,
               extract_gflop=ext_flops / 1e9,
               fp32_peak_share=flops / (fwd_ms * 1e-3) / PEAK_FP32_FLOPS)
    log(f"[learned] {name}: card against CPU maps within {map_err:.3g} (relative), "
        f"{in_set * 100:.2f}% of the CPU's keypoints on the card ({valid} valid{resp}), "
        f"{share * 100:.2f}% of the slots identical, the others at responses within "
        f"{diff_resp:.3g}, descriptors {row['desc']} within "
        f"{desc_err:.3g}; trained {trained}; forward {fwd_ms:.3f} ms for {flops / 1e9:.2f} "
        f"GFLOP ({row['fp32_peak_share'] * 100:.1f}% of the float32 peak), extraction "
        f"{ext_ms:.3f} ms ({ext_flops / 1e9:.2f} GFLOP)")
    row["ok"] = bool(map_err <= LEARNED_TOL and in_set >= LEARNED_MIN_SAME
                     and diff_resp <= LEARNED_TOL and desc_err <= LEARNED_TOL and finite
                     and shape[1] == width and desc_dev == ex_card.device.type and not trained)
    return row


def learned_models_phase(dev, frames):
    """Phase 15a: every learned local-feature model on frame 0 of phase 7's
    stream, card against CPU with the same seeded weights, and its times on
    the card; returns its rows."""
    import importlib

    import torch

    from pyslam_tpu_torch.features.classical import CvSIFTExtractor
    from pyslam_tpu_torch.features.orb2 import ORB2Extractor
    from pyslam_tpu_torch.features.types import DESCRIPTOR_WIDTH, FeatureDescriptorTypes
    from pyslam_tpu_torch.models.contextdesc import ContextDescExtractor
    from pyslam_tpu_torch.models.layers import rgb_image
    from pyslam_tpu_torch.models.patch_descriptors import PatchDescriptorExtractor
    from pyslam_tpu_torch.ops import image as image_ops

    img = frames[0][0]
    devs = {"card": dev, "cpu": torch.device("cpu")}
    rows = {}
    for name, module, cls, n, layout, desc in LEARNED_MODELS:
        ex_cls = getattr(importlib.import_module(f"pyslam_tpu_torch.models.{module}"), cls)
        to = rgb_image if layout == "rgb" else image_ops.gray_image
        rows[name] = _model_row(
            name, ex_cls(n, device=dev), ex_cls(n, device="cpu"),
            lambda d, to=to: to(img, devs[d]), DESCRIPTOR_WIDTH[FeatureDescriptorTypes[desc]],
            lambda ex, x: ex.maps(x), lambda ex, x: ex.extract(x),
            xy_tol=LEARNED_XY_TOL.get(name, 0.0))
        torch.cuda.empty_cache()

    # the patch networks over frame 0's ORB2 keypoints (the card's, on both)
    fd = ORB2Extractor(N_FEATURES, N_LEVELS, device=dev)(img)
    kps = {d: [x.to(devs[d]) for x in (fd.xy, fd.size, fd.angle)] for d in devs}
    gray = {d: image_ops.gray_image(img, devs[d]) for d in devs}
    for kind in PATCH_NETS:
        exs = [PatchDescriptorExtractor(kind, device=d) for d in (dev, "cpu")]
        pat = {d: ex.patches(gray[d], *kps[d]) for d, ex in zip(devs, exs)}
        # the network's map: its output over the same patches (the CPU's);
        # the patches themselves differ by the devices' trigonometry
        same_in = {d: pat["cpu"].to(devs[d]) for d in devs}
        rows[kind] = _model_row(
            f"{kind} over {N_FEATURES} ORB2 keypoints", *exs, lambda d: d, 128,
            lambda ex, d: {"desc": ex.net(same_in[d])},
            lambda ex, d: ex.compute(gray[d], *kps[d]))
        rows[kind]["patches_max_abs_err"] = float((pat["card"].cpu() - pat["cpu"]).abs().max())
        log(f"[learned] {kind}: the sampled patches card against CPU within "
            f"{rows[kind]['patches_max_abs_err']:.3g} grey levels (device trigonometry)")

    # ContextDesc over cv2 SIFT's keypoints (a missing cv2 fails here)
    sift = CvSIFTExtractor(num_features=N_FEATURES, device="cpu")(img)
    skps = {d: [x.to(devs[d]) for x in (sift.xy, sift.size, sift.angle)] for d in devs}
    exs = [ContextDescExtractor(device=d) for d in (dev, "cpu")]
    rows["ContextDesc"] = _model_row(
        f"ContextDesc over {int(sift.valid.sum())} SIFT keypoints ({N_FEATURES} slots)", *exs,
        lambda d: d, 128, lambda ex, d: {"desc": ex.compute(gray[d], *skps[d])},
        lambda ex, d: ex.compute(gray[d], *skps[d]))
    torch.cuda.empty_cache()
    failed = {k: v for k, v in rows.items() if not v["ok"]}
    assert not failed, f"phase 15a: outside the tolerances: {failed}"
    return rows


def learned_sessions_phase(dev, frames, cam, ds):
    """Phase 15b: stereo sessions of the learned presets on the card (no
    integrator, no loop detector), each at its own feature count."""
    import torch

    out = {}
    n = len(frames)
    for preset in LEARNED_SESSIONS:
        sess = preset_session(dev, preset, frames, cam, ds)
        w = WITNESS_LEARNED[preset]
        log(f"[learned] {preset} {n} frames on the card: {sess['n_tracked']} tracked, "
            f"{sess['resets']} resets, {sess['keyframes']} keyframes, ATE {sess['ate']:.4f} m, "
            f"p50 {sess['p50_ms']:.1f} ms; the JAX package on the CPU with its own PRNGKey(0) "
            f"weights (not the port's) over 20 frames: {w[0]} tracked, {w[1]} resets, ATE "
            f"{w[2]} m")
        assert sess["desc_devices"] == [torch.device(dev).type] and sess["described"] >= n, sess
        if preset == "ORB2_HARDNET":
            assert sess["launches"] == n, f"{sess['launches']} fast_nms launches for {n} frames"
        else:
            assert sess["launches"] == 0, sess
        out[preset] = sess
    return out


def _i1_of(xy1, wc):
    """LoFTR's coarse row index of each full-resolution xy1 (cell centres)."""
    xy = np.asarray(xy1).astype(np.int64) // 2
    return (xy[:, 1] - 2) // 4 * wc + (xy[:, 0] - 2) // 4


def loftr_einsum_flops(cfg, n_fine):
    """Floating-point operations of LoFTR outside its Conv2d / Linear
    layers: the linear attention of every encoder application (K^T V, the
    normaliser and Q (K^T V), both views), the coarse similarity matrix and
    the fine heatmap and expectation over ``n_fine`` windows."""
    hc, wc = cfg.img_hw[0] // 8, cfg.img_hw[1] // 8
    n, d_c, d_f, w = hc * wc, cfg.dims[2], cfg.dims[0], cfg.fine_window ** 2

    def attn(tokens, d):
        return 4 * tokens * d * (d // cfg.heads) + 2 * tokens * d

    coarse = 4 * cfg.coarse_layers * attn(n, d_c) + 2 * n * n * d_c
    fine = (4 * cfg.fine_layers * n_fine * attn(w, d_f) + 2 * n_fine * w * d_f
            + 2 * n_fine * w * 2)
    return coarse + fine


def loftr_phase(dev, frames):
    """Phase 16a: LoFTR at its published width on frames 0 and 2 of phase
    11's stream, card against CPU with the same seeded weights; the match
    count at the default threshold, one track_pair's time and GFLOP."""
    import torch

    from pyslam_tpu_torch.features.tracker import feature_tracker_factory
    from pyslam_tpu_torch.models.loftr import LoFTRMatcher

    img1, img2 = frames[0][0], frames[2][0]
    mg, mc = LoFTRMatcher(device=dev), LoFTRMatcher(device="cpu")
    cfg = mg.cfg
    wc = cfg.img_hw[1] // 8
    coarse = {}
    with torch.no_grad():
        for name, m in (("card", mg), ("cpu", mc)):
            f1, f2, _ = m.net.coarse(m.prep(img1), m.prep(img2))
            nn12, conf_all, _, _ = m.net.match_coarse(f1, f2)
            coarse[name] = (nn12.cpu(), conf_all.cpu())
    (nn_g, conf_g), (nn_c, conf_c) = coarse["card"], coarse["cpu"]
    conf_err = float((conf_g - conf_c).abs().max() / conf_c.abs().max())
    nn_same = float((nn_g == nn_c).float().mean())
    n_default = int(mg.run(img1, img2)[3].sum())
    threshold = cfg.conf_threshold
    try:
        mg.cfg.conf_threshold = mc.cfg.conf_threshold = 0.0
        rg = [t.cpu().numpy() for t in mg.run(img1, img2)]
        rc = [t.numpy() for t in mc.run(img1, img2)]
    finally:
        mg.cfg.conf_threshold = mc.cfg.conf_threshold = threshold
    # the matches both keep: the same coarse pair (i1, nn12[i1]), valid in both
    i1g, i1c = _i1_of(rg[0], wc), _i1_of(rc[0], wc)
    rows_c = {int(i): r for r, i in enumerate(i1c) if rc[3][r]}
    both = [(r, rows_c[int(i)]) for r, i in enumerate(i1g)
            if rg[3][r] and int(i) in rows_c and int(nn_g[i]) == int(nn_c[i])]
    xy_err = max((float(np.abs(rg[1][a] - rc[1][b]).max()) for a, b in both), default=0.0)
    tracker = feature_tracker_factory("LOFTR", device=dev)
    pair = lambda: tracker.track_pair(img1, img2)  # noqa: E731
    ms = events_ms(pair, n=5)
    launches, kernel_ms = profile_call(pair)
    flops = (layer_flops([tracker.matcher.net], lambda: tracker.matcher.run(img1, img2))
             + loftr_einsum_flops(cfg, cfg.max_matches))
    out = dict(conf_all_rel_err=conf_err, nn12_identical=nn_same, default_matches=n_default,
               both_kept=len(both), kept_card=int(rg[3].sum()), kept_cpu=int(rc[3].sum()),
               xy2_max_err_px=xy_err, track_pair_ms=ms, gflop=flops / 1e9,
               fp32_peak_share=flops / (ms * 1e-3) / PEAK_FP32_FLOPS,
               launches=launches, kernel_ms=kernel_ms, top_kernels=top_kernels(pair),
               trained=tracker.trained)
    log(f"[loftr] {cfg.img_hw[0]}x{cfg.img_hw[1]}, dims {cfg.dims}, {cfg.coarse_layers} coarse "
        f"pairs, {cfg.heads} heads, {cfg.max_matches} matches, trained {tracker.trained}: card "
        f"against CPU conf_all within {conf_err:.3g} (relative), {nn_same * 100:.2f}% of nn12 "
        f"identical; {n_default} matches at the default threshold {threshold} on the card; "
        f"threshold 0: {out['kept_card']} kept on the card, {out['kept_cpu']} on the CPU, "
        f"{len(both)} by both, fine xy2 within {xy_err:.3g} px; track_pair {ms:.2f} ms "
        f"(CUDA events) for {flops / 1e9:.2f} GFLOP "
        f"({out['fp32_peak_share'] * 100:.1f}% of the float32 peak), {launches} launches and "
        f"{kernel_ms:.2f} ms of kernel time (torch.profiler); top kernels "
        f"{json.dumps(out['top_kernels'])}")
    assert conf_err <= DENSE_TOL and nn_same >= LOFTR_NN_SAME, out
    assert len(both) > 0 and xy_err <= LOFTR_XY_TOL, out
    del mg, mc, tracker
    torch.cuda.empty_cache()
    return out


def attention_flops(cfg, views=2):
    """Floating-point operations of the DUSt3R-class attention products
    (Q K^T and A V) of both views: encoder self-attention, decoder self-
    and cross-attention."""
    n = (cfg.img_hw[0] // cfg.patch) * (cfg.img_hw[1] // cfg.patch)
    enc = cfg.enc_depth * 4 * n * n * cfg.enc_dim
    dec = cfg.dec_depth * 2 * 4 * n * n * cfg.dec_dim
    return views * (enc + dec)


def mast3r_phase(dev, frames, cam, ds):
    """Phase 16b: MASt3R (and DUSt3R from the same trunk) at the published
    width on phase 7's frame 0 pair, card against CPU; match_pair on
    frames 0 and 2; the MAST3R preset through Slam.track() on the first
    MAST3R_FRAMES frames."""
    import copy

    import torch

    from pyslam_tpu_torch.models.dust3r import Dust3rNet
    from pyslam_tpu_torch.models.mast3r import Mast3rModel

    l0, r0 = frames[0][0], frames[0][1]
    t0 = time.perf_counter()
    # one seeded draw of the 0.5 G weights (about 8 s on the host): the
    # card's model is a copy of the CPU's
    mc = Mast3rModel(device="cpu")
    mg = copy.copy(mc)
    mg.device, mg.net = torch.device(dev), copy.deepcopy(mc.net).to(dev)
    build_s = time.perf_counter() - t0
    cfg = mg.cfg
    og, oc = mg.infer_pair(l0, r0), mc.infer_pair(l0, r0)
    names = ("pts3d", "conf", "desc", "desc_conf")
    errs = {f"{k}{v + 1}": float((g.cpu() - c).abs().max() / c.abs().max())
            for v in (0, 1) for k, g, c in zip(names, og[v], oc[v])}
    finite = all(bool(torch.isfinite(t).all()) for view in og for t in view)
    ms = events_ms(lambda: mg.infer_pair(l0, r0), n=5)
    launches, kernel_ms = profile_call(lambda: mg.infer_pair(l0, r0))
    tops = top_kernels(lambda: mg.infer_pair(l0, r0))
    flops = (layer_flops([mg.net], lambda: mg.infer_pair(l0, r0)) + attention_flops(cfg))
    # DUSt3R: the linear heads of the same trunk give MASt3R's pointmaps
    # (the net made on the card, then given MASt3R's weights)
    with torch.device(dev):
        dnet = Dust3rNet(cfg)
    dg = copy.copy(mg)
    dg.net = dnet.to(dev).eval()
    missing, unexpected = dg.net.load_state_dict(mg.net.state_dict(), strict=False)
    assert not missing and all(".head_local_features." in k for k in unexpected), missing
    dp = dg.infer_pair(l0, r0)
    dust_err = max(float((a - b).abs().max()) for a, b in
                   zip(dp, (og[0][0], og[0][1], og[1][0], og[1][1])))
    del dg
    f2 = frames[2][0]
    mg_pairs = mg.match_pair(l0, f2)
    mc_pairs = mc.match_pair(l0, f2)
    out = dict(build_s=build_s, map_rel_err=errs, finite=finite, infer_pair_ms=ms,
               gflop=flops / 1e9, fp32_peak_share=flops / (ms * 1e-3) / PEAK_FP32_FLOPS,
               launches=launches, kernel_ms=kernel_ms, top_kernels=tops,
               dust3r_max_abs_diff=dust_err, matches_card=len(mg_pairs[0]),
               matches_cpu=len(mc_pairs[0]), trained=mg.trained)
    log(f"[mast3r] {cfg.img_hw[0]}x{cfg.img_hw[1]}, patch {cfg.patch}, encoder "
        f"{cfg.enc_depth}x{cfg.enc_dim} ({cfg.enc_heads} heads), decoder {cfg.dec_depth}x"
        f"{cfg.dec_dim} ({cfg.dec_heads} heads), desc_dim {cfg.desc_dim}, trained {mg.trained} "
        f"(both models built in {build_s:.1f} s): card against CPU on frame 0's pair "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})} (relative); "
        f"infer_pair {ms:.2f} ms (CUDA events) for {flops / 1e9:.1f} GFLOP "
        f"({out['fp32_peak_share'] * 100:.1f}% of the float32 peak), {launches} launches and "
        f"{kernel_ms:.2f} ms of kernel time, top kernels {json.dumps(tops)}; DUSt3R on the same "
        f"trunk within {dust_err:.3g} of MASt3R's pointmaps; match_pair frames 0-2: "
        f"{out['matches_card']} matches on the card, {out['matches_cpu']} on the CPU")
    assert finite and max(errs.values()) <= DENSE_TOL and dust_err <= 1e-6, out
    del mg, mc
    torch.cuda.empty_cache()
    n = MAST3R_FRAMES
    sess = preset_session(dev, "MAST3R", frames[:n], cam, ds)
    log(f"[mast3r] MAST3R session, {n} stereo frames through Slam.track() on the card: "
        f"{sess['n_tracked']} tracked, {sess['resets']} resets, {sess['keyframes']} keyframes, "
        f"ATE {sess['ate']:.4f} m, p50 {sess['p50_ms']:.1f} ms (random weights: no floor)")
    assert sess["desc_devices"] == [torch.device(dev).type], sess
    assert sess["described"] >= 2 * n and sess["launches"] == 0, sess
    out["session"] = sess
    return out


def _vpr_frames(dev, frames, n):
    """Port Frames of phase 7's first ``n`` stereo frames on the card with
    the ORB2 tracker, keeping their half-resolution images."""
    from pyslam_tpu_torch.config_parameters import Parameters
    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig, feature_tracker_factory
    from pyslam_tpu_torch.slam.camera import PinholeCamera
    from pyslam_tpu_torch.slam.frame import Frame

    ds = bench_stream()
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                        bf=ds.fx * ds.baseline, depth_threshold=35.0)
    tracker = feature_tracker_factory(FeatureTrackerConfig(num_features=N_FEATURES,
                                                           num_levels=N_LEVELS), device=dev)
    retain = Parameters.kRetainImageForVPR
    Parameters.kRetainImageForVPR = True
    try:
        return [Frame(cam, l, img_right=r, timestamp=ts, feature_tracker=tracker, frame_id=i)
                for i, (l, r, ts) in enumerate(frames[:n])]
    finally:
        Parameters.kRetainImageForVPR = retain


def _on_cpu(frame):
    """A card Frame as the CPU detectors read it: its host fields, and its
    device fields copied to the CPU."""
    from types import SimpleNamespace

    return SimpleNamespace(des=frame.des, valid=frame.valid, img_vpr=frame.img_vpr,
                           img_thumb=frame.img_thumb, dev=lambda name: frame.dev(name).cpu())


def kmeans_rounds(dev, data, init, iters=8):
    """Phase 16c: VLAD's Lloyd rounds on the card against the CPU, both fed
    the CPU's centres in every round.  Returns (the largest relative
    difference of the new centres no near-tie moved a member of, the
    assignments that differed, all at near-ties)."""
    import torch

    from pyslam_tpu_torch.loop_closing import vlad

    dc, dg = torch.from_numpy(data), torch.from_numpy(data).to(dev)
    c_in, err, n_ties = init, 0.0, 0
    for _ in range(iters):
        cc, cg = torch.from_numpy(c_in), torch.from_numpy(c_in).to(dev)
        a_c, a_g = vlad._assign(dc, cc).numpy(), vlad._assign(dg, cg).cpu().numpy()
        new_c = vlad._kmeans(dc, cc, 1).numpy()
        new_g = vlad._kmeans(dg, cg, 1).cpu().numpy()
        differ = a_g != a_c
        score = ((c_in.astype(np.float64) ** 2).sum(1)[None]
                 - 2.0 * data.astype(np.float64) @ c_in.T.astype(np.float64))
        two = np.sort(score, 1)[:, :2]
        assert np.all(two[differ, 1] - two[differ, 0] <= KMEANS_NEAR_TIE * np.abs(score).max())
        moved = np.zeros(len(c_in), bool)
        moved[a_g[differ]] = moved[a_c[differ]] = True
        err = max(err, float(np.abs(new_g[~moved] - new_c[~moved]).max(initial=0.0)
                             / np.abs(new_c).max()))
        n_ties += int(differ.sum())
        c_in = new_c
    return err, n_ties


def vpr_phase(dev, frames):
    """Phase 16c: every other loop detector on the card and on the CPU:
    the descriptors of two of phase 7's frames (VLAD after training on its
    first four), the time of one description on the card; a DBOW3 detector
    with the PRETRAINED vocabulary the phase saves."""
    import dataclasses
    import tempfile

    import torch

    from pyslam_tpu_torch.config_parameters import Parameters
    from pyslam_tpu_torch.loop_closing.loop_closing import LoopDetector
    from pyslam_tpu_torch.loop_closing.loop_detector_configs import (
        LoopDetectorConfigs,
        LoopDetectorVocabularyType,
    )
    from pyslam_tpu_torch.loop_closing.vocabulary import HierarchicalVocabulary

    fr = _vpr_frames(dev, frames, 6)
    train, test = fr[:4], fr[4:]
    on = {"card": lambda f: f, "cpu": _on_cpu}
    rows = {}
    retain = Parameters.kRetainImageForVPR
    try:
        for name in VPR_DETECTORS:
            cfg = LoopDetectorConfigs.get(name)
            dets = {"card": LoopDetector(cfg, device=dev), "cpu": LoopDetector(cfg, device="cpu")}
            row = {}
            if name == "VLAD":
                from pyslam_tpu_torch.loop_closing import vlad

                seeds, kmeans = {}, vlad._kmeans

                def recorded(desc, init, iters, _k=kmeans):
                    seeds[desc.device.type] = (desc.cpu().numpy(), init.cpu().numpy())
                    return _k(desc, init, iters)

                vlad._kmeans = recorded
                try:
                    for where, det in dets.items():
                        for f in train:
                            det.describe_frame(on[where](f))
                        assert det.vlad.trained and det.vlad.consume_just_trained()
                finally:
                    vlad._kmeans = kmeans
                (dg, ig), (dc, ic) = seeds["cuda"], seeds["cpu"]
                assert np.array_equal(dg, dc) and np.array_equal(ig, ic), "k-means inputs"
                row["kmeans_round_rel_err"], row["kmeans_near_ties"] = kmeans_rounds(
                    dev, dc, ic)
                # the descriptors compared below on the same (the card's) centres
                dets["cpu"].vlad._set_centers(dets["card"].vlad.centers)
            errs = []
            for f in test:
                g = dets["card"].describe_frame(f)[1]
                c = dets["cpu"].describe_frame(_on_cpu(f))[1]
                errs.append(float(np.abs(g - c).max() / np.abs(c).max()))
                assert np.isfinite(g).all() and abs(np.linalg.norm(g) - 1.0) < 1e-4
            det = dets["card"]
            row.update(rel_err=max(errs), dim=int(g.shape[0]),
                       describe_ms=events_ms(lambda: det.describe_frame(test[0]), n=10),
                       trained=None if det.netvlad is None else bool(det.netvlad.trained))
            log(f"[vpr] {name}: {row['dim']}-d, card against CPU within {row['rel_err']:.3g} "
                f"(relative) on frames 4-5"
                + (f", the k-means rounds within {row['kmeans_round_rel_err']:.3g} "
                   f"({row['kmeans_near_ties']} near-tie assignments)" if name == "VLAD" else "")
                + f"; one description {row['describe_ms']:.3f} ms on the card (CUDA events)")
            assert row["rel_err"] <= DENSE_TOL and row.get("kmeans_round_rel_err",
                                                           0.0) <= DENSE_TOL, row
            rows[name] = row
            del dets, det
            torch.cuda.empty_cache()
    finally:
        Parameters.kRetainImageForVPR = retain
    # PRETRAINED: a tree trained on frame 0's descriptors, saved, loaded
    voc = HierarchicalVocabulary(branching=8, depth=4, device="cpu")
    voc.words_for(fr[0].des, fr[0].valid)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_voc_") as root:
        path = os.path.join(root, "voc.npz")
        voc.save(path)
        cfg = dataclasses.replace(LoopDetectorConfigs.DBOW3, extra={"vocabulary_path": path},
                                  vocabulary_type=LoopDetectorVocabularyType.PRETRAINED)
        dets = {"card": LoopDetector(cfg, device=dev), "cpu": LoopDetector(cfg, device="cpu")}
    same, hist_err = True, 0.0
    for f in test:
        (wg, hg), (wc, hc) = (d.describe_frame(on[k](f)) for k, d in dets.items())
        same &= bool(np.array_equal(wg, wc))
        hist_err = max(hist_err, float(np.abs(hg - hc).max()))
    rows["PRETRAINED"] = dict(word_ids_identical=same, hist_max_abs_err=hist_err,
                              checksum=dets["card"].vocabulary.checksum())
    log(f"[vpr] DBOW3 with the PRETRAINED vocabulary ({voc.num_words} words, checksum "
        f"{rows['PRETRAINED']['checksum']}): word ids card against CPU "
        f"{'identical' if same else 'DIFFER'}, histograms within {hist_err:.3g}")
    assert same and hist_err <= 1e-6, rows["PRETRAINED"]
    return rows


def vit_flops(n_tokens, dim, depth, sequences=1):
    """The attention products (Q K^T and A V) of ``depth`` ViT blocks over
    ``sequences`` sequences of ``n_tokens``."""
    return sequences * depth * 4 * n_tokens * n_tokens * dim


def depth_model_products(name, cfg, shapes):
    """Floating-point operations of a depth model's products that are not
    layers: attention, and the stereo networks' correlation (the volume,
    and each iteration's window of samples as a multiply-add per channel),
    from the configuration and the input ``shapes``."""
    if name == "depth_anything_v2":
        n = 1 + (cfg.img_hw[0] // cfg.patch) * (cfg.img_hw[1] // cfg.patch)
        return vit_flops(n, cfg.dim, cfg.depth)
    if name == "depth_anything_v3":
        n, v = (cfg.img_hw[0] // cfg.patch) * (cfg.img_hw[1] // cfg.patch), shapes["views"]
        half = cfg.depth // 2
        return vit_flops(n, cfg.dim, half, v) + vit_flops(n * v, cfg.dim, half)
    if name == "depth_pro":
        n = (cfg.patch_px // cfg.vit_patch) ** 2
        return vit_flops(n, cfg.dim, cfg.depth, shapes["patches"] + 1)
    if name == "mvdust3r":
        n, v = (cfg.img_hw[0] // cfg.patch) * (cfg.img_hw[1] // cfg.patch), shapes["views"]
        enc = vit_flops(n, cfg.enc_dim, cfg.enc_depth, v)
        # per layer: the reference's self and cross attention into the
        # sources, each source's self and cross attention into all views
        dec = cfg.dec_depth * 4 * cfg.dec_dim * (n * n + n * (v - 1) * n
                                                  + (v - 1) * (n * n + n * v * n))
        return enc + dec
    h, w = shapes["hw"]
    hq, wq = h // 4, w // 4
    if name == "raft_stereo":
        its = cfg.corr_levels * (2 * cfg.corr_radius + 1) * hq * wq * BILINEAR_1D_OPS
        return 2 * hq * wq * wq * cfg.feat_dim + cfg.iters * its
    if name == "crestereo":
        window = 2 * cfg.radius + 1
        per_it = lambda hh, ww: window * hh * ww * cfg.feat_dim * (2 + BILINEAR_1D_OPS)  # noqa: E731
        return (cfg.iters_coarse * per_it(hq // 2, wq // 2) + cfg.iters_fine * per_it(hq, wq))
    return 0


def depth_models_phase(dev, frames):
    """Phase 17a: each depth model at the JAX package's default
    configuration on phase 7's frame 0, card against CPU, and its times."""
    import copy

    import torch

    from pyslam_tpu_torch.models import (crestereo, depth_anything, depth_anything_v2,
                                         depth_anything_v3, depth_pro, mvdust3r, raft_stereo)

    left, right = frames[0][0], frames[0][1]
    rgb = np.repeat(np.asarray(left, np.float32)[..., None], 3, axis=2)
    h16, w16 = (H // 16) * 16, (W // 16) * 16
    pair = [np.ascontiguousarray(np.asarray(x, np.float32)[:h16, :w16] / 255.0)
            for x in (left, right)]

    def dpt(m):
        return lambda: m.run(torch.from_numpy(rgb).to(m.device))

    def host(m, x):
        return lambda: m.run(x)

    def stereo(m):
        return lambda: m.run(*(torch.from_numpy(p).to(m.device) for p in pair))

    specs = [
        ("dpt_lite", lambda d: depth_anything.DepthAnythingInference(device=d), dpt,
         {"hw": (h16, w16)}),
        ("depth_anything_v2", lambda d: depth_anything_v2.DepthAnythingV2(device=d),
         lambda m: host(m, m.prepare(left)), {}),
        ("depth_anything_v3", lambda d: depth_anything_v3.DepthAnything3(device=d),
         lambda m: lambda: m.run([left, right]), {"views": 2}),
        ("depth_pro", lambda d: depth_pro.DepthPro(device=d),
         lambda m: host(m, m.prepare(left)), {}),
        ("raft_stereo", lambda d: raft_stereo.RaftStereo(device=d), stereo, {"hw": (h16, w16)}),
        ("crestereo", lambda d: crestereo.CREStereo(device=d), stereo, {"hw": (h16, w16)}),
        ("mvdust3r", lambda d: mvdust3r.MVDust3rModel(device=d),
         lambda m: host(m, np.stack([m._prep(left), m._prep(right)])), {"views": 2}),
    ]
    out = {}
    for name, build, runner, shapes in specs:
        t0 = time.perf_counter()
        mc = build("cpu")
        mg = copy.copy(mc)
        mg.device, mg.net = torch.device(dev), copy.deepcopy(mc.net).to(dev)
        if name == "depth_pro":
            shapes["patches"] = sum(len(pos) ** 2 for _, pos in mg.net.layout())
        run_g, run_c = runner(mg), runner(mc)
        og, oc = run_g(), run_c()
        og = og if isinstance(og, tuple) else (og,)
        oc = oc if isinstance(oc, tuple) else (oc,)
        errs = [float((g.cpu() - c).abs().max() / max(float(c.abs().max()), 1e-30))
                for g, c in zip(og, oc)]
        on_card = (all(p.device.type == "cuda" for p in mg.net.parameters())
                   and all(o.device.type == "cuda" for o in og))
        finite = all(bool(torch.isfinite(o).all()) for o in og)
        ms = events_ms(run_g, n=3)
        launches, kernel_ms = profile_call(run_g)
        flops = (layer_flops([mg.net], run_g)
                 + depth_model_products(name, getattr(mg, "cfg", None), shapes))
        row = dict(map_rel_err=max(errs), map_rel_errs=errs, on_card=on_card, finite=finite,
                   forward_ms=ms, gflop=flops / 1e9,
                   fp32_peak_share=flops / (ms * 1e-3) / PEAK_FP32_FLOPS,
                   launches=launches, kernel_ms=kernel_ms, trained=mg.trained,
                   out_shapes=[list(o.shape) for o in og],
                   seconds=time.perf_counter() - t0)
        out[name] = row
        log(f"[depth] {name}: outputs {row['out_shapes']}, card against CPU within "
            f"{row['map_rel_err']:.3g} of each map's largest magnitude "
            f"({', '.join(f'{e:.3g}' for e in errs)}); forward {ms:.2f} ms (CUDA events) for "
            f"{row['gflop']:.2f} GFLOP ({row['fp32_peak_share'] * 100:.1f}% of the float32 "
            f"peak), {launches} launches and {kernel_ms:.2f} ms of kernel time "
            f"(torch.profiler); trained {mg.trained}; {row['seconds']:.1f} s with the CPU run")
        assert on_card and finite and max(errs) <= DENSE_TOL and not mg.trained, (name, row)
        del mg, mc, run_g, run_c, og, oc
        torch.cuda.empty_cache()
    return out


def depth_session(dev, est, frames, cam, ds, integ=None, stereo=True, tag="[depth]"):
    """Phases 17b-c: ``frames`` through Slam(sensor_type=MONOCULAR,
    depth_estimator=est) on the card, with next-frame prefetch (a stereo
    estimator's frames take their right image, which the prefetch needs),
    then finish().  Returns the session's numbers."""
    import torch

    from pyslam_tpu_torch.evaluation.metrics import eval_ate
    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.ops.fast import fast_nms
    from pyslam_tpu_torch.slam.slam import Slam

    slam = Slam(cam, FeatureTrackerConfig(num_features=N_FEATURES, num_levels=N_LEVELS),
                sensor_type=SensorType.MONOCULAR, depth_estimator=est, device=dev)
    if integ is not None:
        slam.set_volumetric_integrator(integ)
    calls, resets = [], []
    infer, reset = est.infer, slam.reset

    def counted_infer(img, img_right=None):
        calls.append(img_right is not None)
        return infer(img, img_right=img_right)

    def counted_reset():
        resets.append(len(calls))
        reset()

    est.infer, slam.reset = counted_infer, counted_reset
    # the keyframe cadence: the frames that made a keyframe, and the back
    # end's readiness at each keyframe decision (the CPU's deterministic
    # model and the card's wall-clock budget part here)
    idle, kf_frames = [], []
    lm_idle = slam.tracking._local_mapping_idle

    def logged_idle():
        idle.append(lm_idle())
        return idle[-1]

    slam.tracking._local_mapping_idle = logged_idle
    n = len(frames)
    torch.cuda.synchronize()
    fast_nms.launches = 0
    lats = []
    t0 = time.perf_counter()
    for i, (img, img_r, ts) in enumerate(frames):
        nxt = None
        if i + 1 < n:
            nxt = {"img": frames[i + 1][0], "frame_id": i + 1, "timestamp": frames[i + 1][2],
                   "img_right": frames[i + 1][1] if stereo else None}
        t1 = time.perf_counter()
        slam.track(img, img_right=img_r if stereo else None, frame_id=i, timestamp=ts,
                   next_input=nxt)
        lats.append(time.perf_counter() - t1)
        kf = slam.tracking.kf_ref
        if kf is not None and kf.id == i:
            kf_frames.append(i)
    slam.finish()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    est.infer = infer
    ts_est, poses = slam.get_final_trajectory()
    gt_t = np.asarray([ds.getTimestamp(i) for i in range(n)])
    ate = (float(eval_ate(ts_est, poses[:, :3, 3], gt_t, ds.poses[:n, :3, 3], align=True,
                          with_scale=False).rmse) if len(ts_est) >= 3 else float("nan"))
    est_len = float(np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1).sum()) \
        if len(ts_est) >= 2 else 0.0
    gt_len = float(np.linalg.norm(np.diff(ds.poses[:n, :3, 3], axis=0), axis=1).sum())
    lat_ms = np.asarray(lats[min(10, n - 1):]) * 1e3
    out = dict(sensor=slam.sensor_type.name, launches=fast_nms.launches,
               n_tracked=len(slam.tracking.history.timestamps), resets=len(resets),
               keyframes=slam.map.num_keyframes(), points=slam.map.num_points(), ate=ate,
               length_m=est_len, gt_length_m=gt_len, estimates=len(calls),
               estimates_with_right=sum(calls), p50_ms=float(np.percentile(lat_ms, 50)),
               wall_s=wall, keyframe_frames=kf_frames, idle_decisions=sum(idle),
               decisions=len(idle))
    if integ is not None:
        out.update(snapshots=len(integ.snapshots), integrated=integ.volume.num_integrated,
                   voxels=integ.volume.num_voxels())
    log(f"{tag} {n} frames through Slam(MONOCULAR, depth_estimator="
        f"{type(est).__name__}) on the card, sensor {out['sensor']}: {out['n_tracked']}/{n} "
        f"tracked, {out['resets']} resets, {out['keyframes']} keyframes, {out['points']} "
        f"points, ATE {ate:.4f} m (no scale), trajectory {est_len:.3f} m against {gt_len:.3f} "
        f"m, {out['estimates']} depth estimates ({out['estimates_with_right']} with the right "
        f"image), fast_nms launches {out['launches']}, p50 {out['p50_ms']:.1f} ms, "
        f"{wall:.1f} s" + (f"; dense: {out['snapshots']} keyframes handed over, "
                           f"{out['integrated']} integrated, {out['voxels']} voxels"
                           if integ is not None else ""))
    log(f"{tag} keyframes made at frames {kf_frames}; the back end idle at "
        f"{out['idle_decisions']} of {out['decisions']} keyframe decisions")
    log(f"{tag} stage totals: " + json.dumps(
        {mod: {k: round(v["total_ms"], 1) for k, v in st.items()}
         for mod, st in slam.timings().items()}))
    assert slam.map.device.type == "cuda"
    return out


def depth_phase(dev, frames, cam, ds, models=None):
    """Phase 17: the depth models card against CPU (a; ``models``, the
    second process's numbers, where they are given), the SGBM upgrade of a
    monocular session with the TSDF (b), the learned upgrades (c)."""
    import torch

    from pyslam_tpu_torch.config_parameters import Parameters
    from pyslam_tpu_torch.dense.volumetric_integrator import (
        VolumetricIntegratorType, volumetric_integrator_factory)
    from pyslam_tpu_torch.depth_estimation.depth_estimator import (DepthEstimatorType,
                                                                   depth_estimator_factory)

    out = {"models": models if models else depth_models_phase(dev, frames)}
    # 17b: the TSDF on the estimated depth (phase 9's integrator)
    saved = Parameters.as_dict()
    try:
        Parameters.kVolumetricIntegrationUseDepthEstimator = False
        Parameters.kVolumetricIntegrationDepthTruncOutdoor = DEPTH_TRUNC_OUTDOOR
        integ = volumetric_integrator_factory(
            VolumetricIntegratorType.TSDF, camera=cam,
            environment_type=type("E", (), {"name": "OUTDOOR"})(),
            voxel_size=VOXEL_SIZE, sdf_trunc=SDF_TRUNC, device=dev)
    finally:
        Parameters.set_from_dict(saved)
    est = depth_estimator_factory(DepthEstimatorType.DEPTH_SGBM, camera=cam, device=dev)
    sg = out["sgbm_upgrade"] = depth_session(dev, est, frames, cam, ds, integ=integ)
    n = len(frames)
    log(f"[depth] SGBM upgrade: the JAX package on the CPU {WITNESS_DEPTH_SGBM[0]}/{n} "
        f"tracked, {WITNESS_DEPTH_SGBM[1]} resets, ATE {WITNESS_DEPTH_SGBM[2]} m (under the "
        f"port's readiness rule {WITNESS_DEPTH_SGBM_PORT_READINESS[2]} m); ceiling "
        f"{DEPTH_SGBM_ATE_MAX:.4f} m")
    assert sg["sensor"] == "RGBD" and est.device.type == "cuda", sg
    assert sg["n_tracked"] == n and sg["launches"] == n, sg
    assert sg["estimates"] == sg["estimates_with_right"] == n, sg
    assert sg["snapshots"] >= 1 and sg["integrated"] == sg["snapshots"], sg
    assert integ.volume.table.tsdf.device.type == "cuda" and sg["voxels"] > 0, sg
    assert abs(sg["length_m"] - sg["gt_length_m"]) <= DEPTH_LENGTH_TOL * sg["gt_length_m"], sg
    assert sg["ate"] < DEPTH_SGBM_ATE_MAX, sg
    del est, integ
    torch.cuda.empty_cache()
    # 17c: the learned estimators on the left images alone
    learned = {}
    m = DEPTH_LEARNED_FRAMES
    for name in ("depth_anything_v2", "mast3r"):
        est = depth_estimator_factory(name, camera=cam, device=dev)
        params = [p.device.type for p in est.model.net.parameters()]
        sess = learned[name] = depth_session(dev, est, frames[:m], cam, ds, stereo=False,
                                             tag=f"[depth] {name}")
        log(f"[depth] {name}: the JAX package on the CPU (tracked, resets, ATE m) "
            f"{WITNESS_DEPTH_LEARNED[name]} (random weights: no floor)")
        assert set(params) == {"cuda"} and not est.model.trained, name
        assert sess["sensor"] == "RGBD" and sess["estimates"] == m, sess
        assert sess["estimates_with_right"] == 0 and sess["launches"] == m, sess
        del est
        torch.cuda.empty_cache()
    out["learned_upgrade"] = learned
    return out


def _logits_err(lg, lc):
    """(relative difference of two logit maps (C, ...) card and CPU, share
    of labels that differ, whether every differing label is a near-tie:
    its two best logits within DENSE_TOL of the largest magnitude)."""
    lg, lc = lg.cpu().numpy(), lc.cpu().numpy()
    scale = max(float(np.abs(lc).max()), 1e-30)
    top2 = np.sort(lc, 0)[-2:]
    differ = lg.argmax(0) != lc.argmax(0)
    ties_ok = bool((top2[1] - top2[0] <= DENSE_TOL * scale)[differ].all())
    return float(np.abs(lg - lc).max() / scale), float(differ.mean()), ties_ok


def yolo_cells(heads, cfg):
    """The grid cells YOLO-seg's decode keeps, level by level: the top
    ``topk_per_level`` best class scores by a stable descending sort (the
    order ``yolo_seg.decode`` returns its candidates in)."""
    import torch

    cells = []
    for cls, _, _ in heads:
        g = cls.shape[-1]
        best = torch.sigmoid(cls).permute(1, 2, 0).reshape(g * g, -1).max(1).values
        order = torch.sort(best, descending=True, stable=True)[1]
        cells.append(order[:min(cfg.topk_per_level, g * g)])
    return torch.cat(cells)


def semantic_models_phase(dev, frames):
    """Phase 18a: each semantic model at the JAX package's default
    configuration on phase 7's frame 0, the same seeded weights on the card
    and the CPU: outputs within DENSE_TOL of their largest magnitude and
    labels identical but at near-ties, then the forward's time (CUDA
    events), GFLOP from the layer shapes (and the attention and mask
    products by hand), launches and kernel time (torch.profiler)."""
    import copy

    import torch

    from pyslam_tpu_torch.models import clip, deeplabv3, detr, segformer, yolo_seg
    from pyslam_tpu_torch.models.layers import autotuned_convs

    left = np.asarray(frames[0][0], np.float32)
    rgb = np.repeat(left[..., None], 3, axis=2)
    prompts = [f"a photo of a {lab}" for lab in SEM_CLIP_LABELS]

    def deeplab_run(m):
        x = m.prepare(rgb)
        return lambda: (m.logits(x),)

    def segformer_run(m):
        return lambda: (m.logits(rgb),)

    def clip_run(m):
        x = m._prep(rgb)
        toks = torch.from_numpy(clip.tokenize(prompts, m.cfg.context)).to(torch.int64)

        def run():
            g, p = m.image_embeddings(x)
            with torch.no_grad():
                t = m.text(toks.to(m.device))
            return g, p, t
        return run

    def yolo_run(m):
        x = torch.from_numpy(m.prepare(rgb))

        def run():
            with torch.no_grad(), autotuned_convs():
                outs, proto = m.net(x.to(m.device))
            return tuple(t for level in outs for t in level) + (proto,)
        return run

    def detr_run(m):
        x = m.prepare(rgb)
        return lambda: m.run(x)

    def extra_flops(name, m):
        if name == "clip":
            c = m.cfg
            n = (c.img_px // c.vit_patch) ** 2 + 1
            text = len(prompts) * c.text_depth * 4 * c.context ** 2 * c.text_dim
            return (vit_flops(n, c.vit_dim, c.vit_depth) + text
                    + 2 * n * c.vit_dim * c.embed_dim + 2 * len(prompts) * c.text_dim * c.embed_dim)
        if name == "detr":
            c = m.cfg
            n = (c.img_px // 16) ** 2
            q = c.num_queries
            return (vit_flops(n, c.dim, c.enc_depth + 1)
                    + c.dec_depth * 4 * c.dim * (q * q + q * n))
        if name == "yolo_seg":
            c = m.cfg
            n = sum(min(c.topk_per_level, (c.img_px // s) ** 2) for s in yolo_seg.STRIDES)
            return 2 * n * c.num_protos * (c.img_px // 8) ** 2
        return 0

    specs = [
        ("deeplabv3", lambda d: deeplabv3.DeepLabV3Segmenter(device=d), deeplab_run,
         lambda m: [m.net]),
        ("segformer", lambda d: segformer.SegFormerInference(device=d), segformer_run,
         lambda m: [m.net]),
        ("clip", lambda d: clip.CLIPModel(device=d), clip_run, lambda m: [m.image, m.text]),
        ("yolo_seg", lambda d: yolo_seg.YoloSeg(device=d), yolo_run, lambda m: [m.net]),
        ("detr", lambda d: detr.DetrModel(device=d), detr_run, lambda m: [m.net]),
    ]
    out = {}
    for name, build, runner, nets in specs:
        t0 = time.perf_counter()
        mc = build("cpu")
        mg = copy.copy(mc)
        mg.device = torch.device(dev)
        for attr in ("net", "image", "text"):
            if hasattr(mc, attr):
                setattr(mg, attr, copy.deepcopy(getattr(mc, attr)).to(dev))
        run_g, run_c = runner(mg), runner(mc)
        og, oc = run_g(), run_c()
        row = {}
        if name in ("deeplabv3", "segformer"):
            err, differ, ties_ok = _logits_err(og[0], oc[0])
            row.update(label_differ=differ)
        elif name == "yolo_seg":
            # the heads and prototypes; then the decode of the CPU's heads
            # on the card against the CPU: the kept cells identical but
            # where two scores tie to within DENSE_TOL (saturated sigmoids
            # the devices round a unit apart reorder), and on the cells
            # both keep at a rank the candidates within DENSE_TOL and the
            # classes identical
            errs = [float((g.cpu() - c).abs().max() / max(float(c.abs().max()), 1e-30))
                    for g, c in zip(og, oc)]
            heads = [tuple(oc[3 * i:3 * i + 3]) for i in range(3)]
            heads_g = [tuple(t.to(dev) for t in h) for h in heads]
            dc = yolo_seg.decode(heads, oc[-1], mc.cfg)
            dg = [t.cpu() for t in yolo_seg.decode(heads_g, oc[-1].to(dev), mc.cfg)]
            same = yolo_cells(heads_g, mc.cfg).cpu() == yolo_cells(heads, mc.cfg)
            errs += [float((g[same] - c[same]).abs().max() / max(float(c.abs().max()), 1e-30))
                     for i, (g, c) in enumerate(zip(dg, dc)) if i != 1]
            errs.append(float((dg[0] - dc[0]).abs().max()))          # scores, by rank
            err = max(errs)
            ties_ok = (bool(torch.equal(dg[1][same], dc[1][same]))
                       and bool(((dg[0] - dc[0]).abs()[~same] <= DENSE_TOL).all()))
            row.update(cells_reordered=int((~same).sum()), cells=int(same.numel()),
                       heads_rel_err=max(errs[:len(oc)]))
        elif name == "detr":
            errs = [float((g.cpu() - c).abs().max() / max(float(c.abs().max()), 1e-30))
                    for g, c in zip(og, oc)]
            err, differ, ties_ok = _logits_err(og[0].T, oc[0].T)
            err = max(errs)
            row.update(label_differ=differ)
        else:
            errs = [float((g.cpu() - c).abs().max() / max(float(c.abs().max()), 1e-30))
                    for g, c in zip(og, oc)]
            err = max(errs)
            sims_g = torch.nn.functional.normalize(og[1], dim=-1) @ \
                torch.nn.functional.normalize(og[2], dim=-1).T
            sims_c = torch.nn.functional.normalize(oc[1], dim=-1) @ \
                torch.nn.functional.normalize(oc[2], dim=-1).T
            _, differ, ties_ok = _logits_err(sims_g.permute(2, 0, 1), sims_c.permute(2, 0, 1))
            row.update(label_differ=differ)
        params = [p for net in nets(mg) for p in net.parameters()]
        on_card = (all(p.device.type == "cuda" for p in params)
                   and all(o.device.type == "cuda" for o in og))
        finite = all(bool(torch.isfinite(o.float()).all()) for o in og)
        ms = events_ms(run_g, n=5)
        launches, kernel_ms = profile_call(run_g)
        flops = layer_flops(nets(mg), run_g) + extra_flops(name, mg)
        row.update(rel_err=err, near_ties_only=ties_ok, on_card=on_card, finite=finite,
                   forward_ms=ms, gflop=flops / 1e9,
                   fp32_peak_share=flops / (ms * 1e-3) / PEAK_FP32_FLOPS, launches=launches,
                   kernel_ms=kernel_ms, trained=mg.trained,
                   out_shapes=[list(o.shape) for o in og], seconds=time.perf_counter() - t0)
        out[name] = row
        log(f"[semantic] {name}: outputs {row['out_shapes']}, card against CPU within "
            f"{err:.3g} of the largest magnitude, labels differing "
            f"{row.get('label_differ', 0.0) * 100:.3f}% (near-ties only: {ties_ok})"
            + (f", {row['cells_reordered']} of {row['cells']} decoded cells reordered at "
               f"near-tied scores" if name == "yolo_seg" else "") + "; forward "
            f"{ms:.2f} ms (CUDA events) for {row['gflop']:.2f} GFLOP "
            f"({row['fp32_peak_share'] * 100:.1f}% of the float32 peak), {launches} launches "
            f"and {kernel_ms:.2f} ms of kernel time (torch.profiler); trained {mg.trained}; "
            f"{row['seconds']:.1f} s with the CPU run")
        assert on_card and finite and err <= DENSE_TOL and ties_ok and not mg.trained, \
            (name, row)
        del mg, mc, run_g, run_c, og, oc
        torch.cuda.empty_cache()
    return out


def semantic_session(dev, frames, cam, ds, sem, integ=None):
    """Phase 18b-c: ``frames`` through the stereo Slam on the card with the
    semantic mapper ``sem`` attached (and ``integ``), with next-frame
    prefetch, then finish().  Returns the session's numbers, the Slam and
    what the mapper segmented: (keyframe, image, the points it observed
    then)."""
    import torch

    from pyslam_tpu_torch.evaluation.metrics import eval_ate
    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.ops.fast import fast_nms
    from pyslam_tpu_torch.slam.slam import Slam

    slam = Slam(cam, FeatureTrackerConfig(num_features=N_FEATURES, num_levels=N_LEVELS),
                sensor_type=SensorType.STEREO, device=dev)
    if integ is not None:
        slam.set_volumetric_integrator(integ)
    sem.reset(slam.map)
    slam.set_semantic_mapping(sem)
    segmented, weights = [], []
    process, weight = sem.process_keyframe, sem.get_semantic_weight

    def recorded_process(kf, img):
        segmented.append((kf, img, kf.points[kf.points >= 0].copy()))
        return process(kf, img)

    def recorded_weight(labels):
        w = weight(labels)
        weights.append((int(np.size(w)), int((np.asarray(w) < 1.0).sum())))
        return w

    sem.process_keyframe, sem.get_semantic_weight = recorded_process, recorded_weight
    n = len(frames)
    torch.cuda.synchronize()
    fast_nms.launches = 0
    lats = []
    t_start = None
    for i, (img_l, img_r, ts) in enumerate(frames):
        if i == min(10, n - 1):
            t_start = time.perf_counter()
        nxt = None
        if i + 1 < n:
            nl, nr, nts = frames[i + 1]
            nxt = {"img": nl, "img_right": nr, "frame_id": i + 1, "timestamp": nts}
        t1 = time.perf_counter()
        slam.track(img_l, img_right=img_r, frame_id=i, timestamp=ts, next_input=nxt)
        lats.append(time.perf_counter() - t1)
    slam.finish()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    del sem.process_keyframe, sem.get_semantic_weight
    ts_est, poses = slam.get_final_trajectory()
    gt_t = np.asarray([ds.getTimestamp(i) for i in range(n)])
    ate = (float(eval_ate(ts_est, poses[:, :3, 3], gt_t, ds.poses[:n, :3, 3], align=True,
                          with_scale=False).rmse) if len(ts_est) >= 3 else float("nan"))
    lat_ms = np.asarray(lats[min(10, n - 1):]) * 1e3
    last = weights[-1] if weights else (0, 0)
    out = dict(launches=fast_nms.launches, n_tracked=len(slam.tracking.history.timestamps),
               keyframes=slam.map.num_keyframes(), points=slam.map.num_points(), ate=ate,
               handed_over=len(segmented), queue_left=len(sem.queue),
               labelled=sum(getattr(kf, "kps_sem", None) is not None
                            for kf in slam.map.keyframes.values()),
               scored_points=len(sem.point_scores), weighted_lbas=len(weights),
               down_weighted=sum(d for _, d in weights), last_lba_observations=last[0], last_lba_down_weighted=last[1],
               p50_ms=float(np.percentile(lat_ms, 50)), p95_ms=float(np.percentile(lat_ms, 95)),
               fps=(n - min(10, n - 1)) / wall, wall_s=wall)
    assert slam.map.device.type == "cuda"
    return out, slam, segmented


def semantic_phase(dev, frames, cam, ds, voxels_per_frame=None, models=None):
    """Phase 18: the semantic models card against CPU (a); the weight-free
    semantic session on phase 7's stream with the semantic integrator and
    the BA weighting, with its floor, then one keyframe's semantic
    integration card against CPU (b); the learned segmenters through
    Slam.track() (c)."""
    import torch

    from pyslam_tpu_torch.config_parameters import Parameters
    from pyslam_tpu_torch.dense.semantic_volume import SemanticFusionMethod, SemanticTSDFVolume
    from pyslam_tpu_torch.dense.volumetric_integrator import VolumetricIntegratorType
    from pyslam_tpu_torch.semantics.semantic_mapping import (SemanticFeatureType,
                                                             SemanticMappingConfig,
                                                             SemanticMappingDense)
    from pyslam_tpu_torch.semantics.semantic_segmentation import (IntensityBandSegmentation,
                                                                  semantic_segmentation_factory)
    from pyslam_tpu_torch.slam.map import Map

    out = {"models": models if models else semantic_models_phase(dev, frames)}
    # 18b: the weight-free session with a floor
    frames_b = frames[:SEM_FRAMES]
    n = len(frames_b)
    bands = IntensityBandSegmentation(19)
    sem = SemanticMappingDense(Map(device=dev), SemanticMappingConfig(num_classes=19,
                                                                      dataset="cityscapes"),
                               segmenter=bands)
    saved = Parameters.as_dict()
    try:
        integ = build_integrator(cam, dev, VolumetricIntegratorType.VOXEL_SEMANTIC_GRID)
        Parameters.kUseSemanticsInOptimization = True
        sb, slam, segmented = semantic_session(dev, frames_b, cam, ds, sem, integ)
    finally:
        Parameters.set_from_dict(saved)
    assert isinstance(integ.volume, SemanticTSDFVolume)
    # every keyframe handed over: its labels are the bands of the image it
    # was offered, under its rounded raw keypoints; every point it observed
    # then has scores now (or its replacement has), unless deleted since (a
    # point a later keyframe adds to a segmented one gets none from it)
    unscored = []
    for kf, img, pids in segmented:
        want = bands.infer(frames[kf.id][0])["labels"]
        assert img is frames[kf.id][0], kf.id
        xs = np.clip(np.round(kf.kps_raw[:, 0]).astype(int), 0, W - 1)
        ys = np.clip(np.round(kf.kps_raw[:, 1]).astype(int), 0, H - 1)
        assert np.array_equal(kf.kps_sem, want[ys, xs]), kf.id
        unscored += [int(p) for p in slam.map.resolve_replacements(pids)
                     if p >= 0 and slam.map.points.valid[p] and int(p) not in sem.point_scores]
    dropped, valid = keyframe_drops(integ.volume, integ._depth_provider, cam, frames_b[-1][0],
                                    frames_b[-1][1], ds.poses[n - 1])
    # the ceiling from the frames this session ran (phase 7 counts all its frames)
    if voxels_per_frame is None:
        voxels_per_frame = frame_voxels(integ.volume, integ._depth_provider, cam, frames_b,
                                        ds.poses[:n])
    table = check_table(integ.volume.table, integ.volume.num_integrated, voxels_per_frame[:n],
                        dropped / max(valid, 1))
    sb.update(unscored_points=len(unscored), integrated=integ.volume.num_integrated,
              voxels=integ.volume.num_voxels(), load=table["load"],
              load_ceiling=table["load_ceiling"], drop_share=table["drop_share"])
    log(f"[semantic] weight-free session (intensity bands, 19 classes, Cityscapes weights, "
        f"kUseSemanticsInOptimization on, VOXEL_SEMANTIC_GRID): {sb['n_tracked']}/{n} tracked, "
        f"ATE {sb['ate']:.4f} m, {sb['fps']:.2f} FPS over frames 10-{n - 1}, p50 "
        f"{sb['p50_ms']:.1f} ms p95 {sb['p95_ms']:.1f} ms, fast_nms launches {sb['launches']}; "
        f"{sb['handed_over']} keyframes segmented ({sb['labelled']} of {sb['keyframes']} in the "
        f"map labelled), {sb['scored_points']} points scored, {sb['unscored_points']} unscored; "
        f"{sb['weighted_lbas']} weighted local BAs ({sb['down_weighted']} observations "
        f"down-weighted in all), the last down-weighted {sb['last_lba_down_weighted']} of "
        f"{sb['last_lba_observations']} observations; dense: "
        f"{sb['integrated']} keyframes integrated, {sb['voxels']} voxels, load "
        f"{sb['load']:.4f} (ceiling {sb['load_ceiling']:.4f}), drop {sb['drop_share'] * 100:.3f}%")
    assert sb["n_tracked"] == n and sb["launches"] == n, sb
    assert np.isfinite(sb["ate"]) and sb["ate"] < ATE_MAX, sb
    assert sb["handed_over"] >= 2 and sb["queue_left"] == 0 and not unscored, sb
    assert sb["integrated"] >= 1 and integ.volume.class_scores.device.type == "cuda", sb
    # one keyframe's semantic integration, card against CPU
    kf0 = segmented[0][0]
    depth = integ._depth_provider.infer_depth_device(frames[kf0.id][0], frames[kf0.id][1])
    depth = depth.cpu().numpy()
    seg0 = bands.infer(frames[kf0.id][0])
    fusions = {}
    for fusion in (SemanticFusionMethod.COUNTING, SemanticFusionMethod.BAYESIAN):
        vols = [SemanticTSDFVolume(num_classes=19, fusion=fusion, voxel_size=VOXEL_SIZE,
                                   sdf_trunc=SDF_TRUNC, depth_trunc=DEPTH_TRUNC_OUTDOOR,
                                   device=d) for d in (dev, "cpu")]
        for v in vols:
            v.integrate_semantic(depth, frames[kf0.id][0], seg0["labels"], kf0.Twc, cam.K,
                                 label_probs=seg0["probs"])
        vg, vc = vols
        same = all(np.array_equal(vg._np(k), vc._np(k)) for k in ("keys", "occupied"))
        sc = vc.class_scores
        err = float((vg.class_scores.cpu() - sc).abs().max() / max(float(sc.abs().max()), 1e-30))
        fusions[fusion.value] = dict(slots_keys_identical=same, class_scores_rel_err=err,
                                     voxels=vg.num_voxels())
        log(f"[semantic] integrate_semantic {fusion.value} on keyframe {kf0.kid} (frame "
            f"{kf0.id}): {vg.num_voxels()} voxels, slots and keys "
            f"{'identical' if same else 'DIFFER'} on the card and the CPU, class scores within "
            f"{err:.3g} of the largest")
        assert same and err <= SEM_SCORES_TOL and vg.num_voxels() > 0, fusions
        del vols, vg, vc
    sb["integrate_semantic"] = fusions
    out["session"] = sb
    del slam, integ, segmented
    torch.cuda.empty_cache()
    # 18c: the learned segmenters through Slam.track() (random weights)
    learned = {}
    m = SEM_LEARNED_FRAMES
    for name, cfg in (("segformer", SemanticMappingConfig("segformer", 19)),
                      ("clip", SemanticMappingConfig(
                          "clip", feature_type=SemanticFeatureType.FEATURE_VECTOR))):
        seg = semantic_segmentation_factory(cfg.segmentation_type, cfg.num_classes, device=dev)
        sem = SemanticMappingDense(Map(device=dev), cfg, segmenter=seg)
        sess, slam, segmented = semantic_session(dev, frames[:m], cam, ds, sem)
        nets = [seg.model.net] if name == "segformer" else [seg.model.image, seg.model.text]
        params = {p.device.type for net in nets for p in net.parameters()}
        if name == "clip":
            pids, sims = sem.query_points_by_text("vehicle", top_k=10)
            sess.update(query_pids=len(pids), query_best=float(sims[0]) if len(sims) else None,
                        embedded_points=len(sem.point_embeddings))
            assert len(pids) > 0 and np.isfinite(sims).all(), sess
        learned[name] = sess
        log(f"[semantic] {name} through Slam.track(): {sess['n_tracked']}/{m} tracked, ATE "
            f"{sess['ate']:.4f} m, {sess['handed_over']} keyframes segmented on the card "
            f"({sess['labelled']} of {sess['keyframes']} in the map labelled), "
            f"{sess['scored_points']} points scored, p50 {sess['p50_ms']:.1f} ms, fast_nms "
            f"launches {sess['launches']}"
            + (f"; query 'vehicle': {sess['query_pids']} points, best {sess['query_best']:.4f}"
               if name == "clip" else "") + " (random weights: no floor)")
        assert params == {"cuda"} and seg.device.type == "cuda", (name, params)
        assert sess["handed_over"] >= 1 and sess["queue_left"] == 0, sess
        assert sess["launches"] == m, sess
        del seg, sem, slam, segmented
        torch.cuda.empty_cache()
    out["learned_sessions"] = learned
    return out


def recon_models_phase(dev, views):
    """Phase 19a: VGGT and Fast3R at their default configurations on the
    views of main_scene_from_views, card against CPU, and their times."""
    import copy

    import torch

    from pyslam_tpu_torch.models import fast3r, vggt

    out = {}
    for name, build in (("vggt", lambda d: vggt.VGGTModel(device=d)),
                        ("fast3r", lambda d: fast3r.Fast3RModel(device=d))):
        t0 = time.perf_counter()
        mc = build("cpu")
        mg = copy.copy(mc)
        mg.device, mg.net = torch.device(dev), copy.deepcopy(mc.net).to(dev)
        c = mc.cfg
        hc, hg = mc.infer_views(views), mg.infer_views(views)
        errs = {k: float(np.abs(hg[k] - hc[k]).max() / max(float(np.abs(hc[k]).max()), 1e-30))
                for k in hc}
        finite = all(np.isfinite(v).all() for v in hg.values())
        on_card = all(p.device.type == "cuda" for p in mg.net.parameters())
        xb = torch.from_numpy(vggt.prep_views(views, c.img_hw)).to(dev)

        def fwd(net=mg.net, xb=xb):
            with torch.no_grad():
                return net(xb)

        ms = events_ms(fwd, n=3)
        launches, kernel_ms = profile_call(fwd)
        n = (c.img_hw[0] // c.patch) * (c.img_hw[1] // c.patch)
        v = len(views)
        if name == "vggt":
            attn = vit_flops(n + 1, c.dim, c.depth_pairs, v) + vit_flops(v * (n + 1), c.dim,
                                                                         c.depth_pairs)
        else:
            attn = vit_flops(n, c.enc_dim, c.enc_depth, v) + vit_flops(v * n, c.dec_dim,
                                                                       c.dec_depth)
        flops = layer_flops([mg.net], fwd) + attn
        row = dict(rel_errs=errs, rel_err=max(errs.values()), finite=finite, on_card=on_card,
                   forward_ms=ms, gflop=flops / 1e9, attention_gflop=attn / 1e9,
                   fp32_peak_share=flops / (ms * 1e-3) / PEAK_FP32_FLOPS, launches=launches,
                   kernel_ms=kernel_ms, trained=mg.trained, seconds=time.perf_counter() - t0)
        out[name] = row
        log(f"[recon] {name} ({v} views {c.img_hw[0]}x{c.img_hw[1]}): card against CPU within "
            f"{row['rel_err']:.3g} of each output's largest magnitude ("
            + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
            + f"); forward {ms:.2f} ms (CUDA events) for {row['gflop']:.2f} GFLOP "
            f"({row['attention_gflop']:.2f} in attention; {row['fp32_peak_share'] * 100:.1f}% of "
            f"the float32 peak), {launches} launches and {kernel_ms:.2f} ms of kernel time "
            f"(torch.profiler); trained {mg.trained}; {row['seconds']:.1f} s with the CPU run")
        assert on_card and finite and row["rel_err"] <= RECON_TOL and not mg.trained, (name, row)
        del mg, mc, xb
        torch.cuda.empty_cache()
    return out


def rot_errors_deg(poses, gt):
    """Each view's rotation against the ground truth's, both relative to
    view 0 (degrees)."""
    g0 = np.linalg.inv(gt[0])
    out = []
    for P, G in zip(poses, gt):
        R, Rg = P[:3, :3], (g0 @ G)[:3, :3]
        out.append(np.degrees(np.arccos(np.clip((np.trace(R.T @ Rg) - 1) / 2, -1.0, 1.0))))
    return np.asarray(out)


def scene_phase(dev):
    """Phases 19b-c: main_scene_from_views GEOMETRIC on the card and on the
    CPU, then every other SceneFromViewsType through the factory on the
    card."""
    import tempfile

    import torch

    from pyslam_tpu_torch import main_scene_from_views
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.io.synthetic import SyntheticDataset
    from pyslam_tpu_torch.ops.fast import fast_nms
    from pyslam_tpu_torch.scene_from_views.scene_from_views import (SceneFromViewsType,
                                                                    scene_from_views_factory)
    from pyslam_tpu_torch.slam.camera import PinholeCamera

    v = SCENE_VIEWS
    ds = SyntheticDataset(num_frames=v * 3, sensor_type=SensorType.MONOCULAR, trajectory="line",
                          step=0.5)
    views = [ds.getImage(i * 3) for i in range(v)]
    gt = np.stack([ds.poses[i * 3] for i in range(v)])
    out = {}
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "scene.npz")
        args = ["--type", "geometric", "--views", str(v), "--save", path]
        t0 = time.perf_counter()
        fast_nms.launches = 0
        res = main_scene_from_views.run(args)
        torch.cuda.synchronize()
        launches, secs = fast_nms.launches, time.perf_counter() - t0
        with np.load(path) as z:
            reloaded = (np.array_equal(z["poses"], res.poses)
                        and np.array_equal(z["points"], res.points))
        cpu = main_scene_from_views.run(args[:-1] + [os.path.join(td, "cpu.npz"),
                                                     "--device", "cpu"])
    rot = rot_errors_deg(res.poses, gt)
    geo = dict(launches=launches, seconds=secs, matches=res.per_view_matches,
               matches_cpu=cpu.per_view_matches, rot_err_deg=rot.tolist(),
               points=len(res.points), reloaded=reloaded)
    out["geometric"] = geo
    log(f"[scene] main_scene_from_views --type geometric --views {v} on the card: "
        f"{secs:.2f} s, fast_nms launches {launches}, matches {res.per_view_matches} (the CPU "
        f"{cpu.per_view_matches}), rotation against the ground truth "
        f"{', '.join(f'{e:.4f}' for e in rot)} deg (floor {SCENE_ROT_MAX_DEG}), "
        f"{len(res.points)} points, the saved npz reloads: {reloaded}")
    assert launches == v, launches
    assert res.per_view_matches == cpu.per_view_matches, geo
    assert min(res.per_view_matches) >= 30, geo
    assert rot.max() <= SCENE_ROT_MAX_DEG, geo
    assert len(res.points) > 0 and np.isfinite(res.points).all() and reloaded, geo
    # 19c: the network backends (random weights: no floor on quality)
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy)
    others = {}
    for t in SceneFromViewsType:
        if t == SceneFromViewsType.GEOMETRIC:
            continue
        t0 = time.perf_counter()
        sv = scene_from_views_factory(t, camera=cam, device=dev)
        r = sv.reconstruct(views)
        torch.cuda.synchronize()
        on_card = all(p.device.type == "cuda" for p in sv.model.net.parameters())
        row = dict(seconds=time.perf_counter() - t0, points=len(r.points),
                   finite=bool(np.isfinite(r.poses).all() and np.isfinite(r.points).all()),
                   poses_shape=list(r.poses.shape), on_card=on_card)
        others[t.value] = row
        log(f"[scene] {t.value}: poses {row['poses_shape']}, {row['points']} points, finite "
            f"{row['finite']}, {row['seconds']:.2f} s with the model's build (random weights)")
        assert row["finite"] and row["poses_shape"] == [v, 4, 4] and on_card, (t, row)
        assert row["points"] > 0, (t, row)
        del sv, r
        torch.cuda.empty_cache()
    out["backends"] = others
    return out


def psnr(a, b):
    return float(-10.0 * np.log10(max(float(np.mean((a - b) ** 2)), 1e-12)))


def gs_phase(dev, frames, cam, ds):
    """Phase 19d: the Gaussian-splatting session on the first GS_FRAMES
    RGBD frames of phase 9, its renders, save / load, the rasterizer's and
    an optimiser step's cost, and one full-size rasterize card against
    CPU."""
    import tempfile

    import torch

    from pyslam_tpu_torch.config_parameters import Parameters
    from pyslam_tpu_torch.dense.gaussian_splatting_integrator import GaussianSplattingVolume
    from pyslam_tpu_torch.dense.volumetric_integrator import volumetric_integrator_factory
    from pyslam_tpu_torch.evaluation.metrics import eval_ate
    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.ops import gaussian_splatting as gs
    from pyslam_tpu_torch.ops.fast import fast_nms
    from pyslam_tpu_torch.slam.slam import Slam

    n = len(frames)
    Parameters.kVolumetricIntegrationUseDepthEstimator = False
    Parameters.kVolumetricIntegrationDepthTruncOutdoor = GS_DEPTH_TRUNC
    integ = volumetric_integrator_factory("gaussian_splatting", camera=cam,
                                          environment_type=type("E", (), {"name": "OUTDOOR"})(),
                                          device=dev)
    vol = integ.volume
    assert isinstance(vol, GaussianSplattingVolume) and integ._depth_provider is None
    assert (vol.capacity, vol.tile_k, vol.steps_per_kf, vol.window, vol.seed_stride) == \
        (60000, 48, 30, 3, 4)
    kf_ms = []
    integrate = vol.integrate

    def timed(*args, **kw):
        if kw.get("phase", 0) != kw.get("phases", 1) - 1:
            return integrate(*args, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        integrate(*args, **kw)
        torch.cuda.synchronize()
        kf_ms.append((time.perf_counter() - t1) * 1e3)

    vol.integrate = timed
    # each keyframe's view rendered after its seeding and after its steps
    seeded, fitted = [], []
    optimize = vol._optimize

    def recorded(K):
        Tcw, img_t, _ = vol._views[-1]
        seeded.append(psnr(vol.render(Tcw, K)[0][..., 0], img_t[..., 0]))
        loss = optimize(K)
        fitted.append(psnr(vol.render(Tcw, K)[0][..., 0], img_t[..., 0]))
        return loss

    vol._optimize = recorded
    slam = Slam(cam, FeatureTrackerConfig(num_features=N_FEATURES, num_levels=N_LEVELS),
                sensor_type=SensorType.RGBD, device=dev)
    slam.set_volumetric_integrator(integ)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fast_nms.launches = 0
    t0 = time.perf_counter()
    lats = []
    for i, (img, depth, ts) in enumerate(frames):
        nxt = None
        if i + 1 < n:
            nxt = {"img": frames[i + 1][0], "frame_id": i + 1, "timestamp": frames[i + 1][2],
                   "depth": frames[i + 1][1]}
        t1 = time.perf_counter()
        slam.track(img, depth=depth, frame_id=i, timestamp=ts, next_input=nxt)
        lats.append(time.perf_counter() - t1)
    slam.finish()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fast_nms.launches
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    n_tracked = len(slam.tracking.history.timestamps)
    ts_est, poses = slam.get_final_trajectory()
    gt_t = np.asarray([ds.getTimestamp(i) for i in range(n)])
    ate = float(eval_ate(ts_est, poses[:, :3, 3], gt_t, ds.poses[:n, :3, 3], align=True,
                         with_scale=False).rmse)
    K = cam.K
    rh, rw = vol.render_hw
    psnrs = []
    for kid, snap in integ.snapshots.items():
        color = vol.render(np.linalg.inv(snap.Twc), K)[0][..., 0]
        target = np.asarray(snap.intensity, np.float32)[:rh, :rw] / 255.0
        psnrs.append(psnr(color, target))
    out = dict(n_tracked=n_tracked, launches=launches, ate=ate, keyframes=slam.map.num_keyframes(),
               snapshots=len(integ.snapshots), integrated=vol.num_integrated,
               gaussians=vol.num_used, kf_integrate_ms=kf_ms, peak_mb=peak_mb,
               psnr_db=psnrs, mean_psnr_db=float(np.mean(psnrs)) if psnrs else None,
               seeded_psnr_db=seeded, fitted_psnr_db=fitted,
               fps=n / wall, p50_ms=float(np.percentile(np.asarray(lats) * 1e3, 50)))
    log(f"[gs] RGBD session with the Gaussian-splatting integrator (capacity {vol.capacity}, "
        f"tile_k {vol.tile_k}, {vol.steps_per_kf} steps, window {vol.window}, stride "
        f"{vol.seed_stride}, raster {rh}x{rw}): {n_tracked}/{n} tracked, fast_nms launches "
        f"{launches}, {out['keyframes']} keyframes, {out['snapshots']} handed over, "
        f"{out['integrated']} integrated, {vol.num_used} gaussians, ATE {ate:.4f} m, "
        f"{out['fps']:.2f} FPS, p50 {out['p50_ms']:.1f} ms; a keyframe's integration "
        f"(seeding + {vol.steps_per_kf} steps) "
        + ", ".join(f"{t:.0f}" for t in kf_ms) + " ms (two renders included); PSNR at the "
        "keyframes' poses after their seeding " + ", ".join(f"{p:.2f}" for p in seeded)
        + " dB, after their steps " + ", ".join(f"{p:.2f}" for p in fitted)
        + " dB, at the session's end " + ", ".join(f"{p:.2f}" for p in psnrs)
        + f" dB (means {np.mean(seeded):.2f}, {np.mean(fitted):.2f}, "
        f"{out['mean_psnr_db']:.2f}); peak device memory {peak_mb:.1f} MiB "
        f"(torch.cuda.max_memory_allocated)")
    assert n_tracked == n and launches == n, out
    assert out["snapshots"] >= 1 and out["integrated"] == out["snapshots"], out
    assert np.isfinite(ate) and ate < ATE_MAX, out
    # each keyframe's view once its steps ran: the map explains what it
    # has just seen; the end of the session is reported beside it (a view
    # drifts once it leaves the window)
    assert np.mean(fitted) >= GS_PSNR_MIN, out
    assert vol.device.type == "cuda"
    # save / load
    snap = next(iter(integ.snapshots.values()))
    Tcw = np.linalg.inv(snap.Twc)
    color = vol.render(Tcw, K)[0]
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "gs.npz")
        integ.save(path)
        back = GaussianSplattingVolume(capacity=vol.capacity, tile_k=vol.tile_k, device=dev)
        back.load(path)
    out["save_load_max_abs"] = float(np.abs(back.render(Tcw, K)[0] - color).max())
    assert out["save_load_max_abs"] <= GS_SAVE_TOL and back.num_used == vol.num_used, out
    del back
    # the cost of one rasterize, of one optimiser step over the window, and
    # the tile-score pass against its byte bound
    g = vol.g
    Tcw_t = torch.as_tensor(Tcw, dtype=torch.float32, device=dev)
    K_t = torch.as_tensor(K, dtype=torch.float32, device=dev)

    def raster():
        with torch.no_grad():
            return gs.rasterize(g, Tcw_t, K_t, rh, rw, vol.tile_k)

    r_ms = events_ms(raster, n=5)
    r_launches, r_kernel_ms = profile_call(raster)
    views = list(vol._views)
    Tcws, targets, depths = (torch.as_tensor(np.stack([w[i] for w in views]), device=dev)
                             for i in range(3))
    g_copy = gs.Gaussians(*[x.detach().clone() for x in g])

    def step():
        gs.optimize_gaussians(g_copy, None, Tcws, K_t, targets, depths, rh, rw, vol.tile_k, 1)

    s_ms = events_ms(step, n=3)
    s_launches, s_kernel_ms = profile_call(step)
    mean2d, _, _, radius, _, ok = gs.project_gaussians(g, Tcw_t, K_t)
    cyx = gs.tile_centers(rh // gs.TILE, rw // gs.TILE, dev)
    n_g, n_t = mean2d.shape[0], cyx.shape[0]

    def scores():
        with torch.no_grad():
            return gs.tile_scores(cyx, mean2d, radius, ok)

    sc_ms = events_ms(scores, n=5)
    # each input read once (centres, 2D means, radii, validity), the (T, N)
    # score matrix written once; per element 2 subtracts, 2 multiplies, an
    # add, a sqrt, 2 subtracts and a select
    sc_bound = bound(n_t * 8 + n_g * (8 + 4 + 1) + n_t * n_g * 4, 9 * n_t * n_g)
    out.update(rasterize_ms=r_ms, rasterize_launches=r_launches,
               rasterize_kernel_ms=r_kernel_ms, step_ms=s_ms, step_launches=s_launches,
               step_kernel_ms=s_kernel_ms, step_views=len(views), tile_score_ms=sc_ms,
               tile_score_bound_ms=sc_bound["bound_ms"], tile_score_bound_by=sc_bound["bound_by"],
               tiles=n_t, capacity=n_g)
    log(f"[gs] one rasterize ({n_t} tiles x {n_g} gaussians, k {vol.tile_k}): {r_ms:.2f} ms "
        f"(CUDA events), {r_launches} launches and {r_kernel_ms:.2f} ms of kernel time "
        f"(torch.profiler); one optimiser step over {len(views)} views: {s_ms:.2f} ms, "
        f"{s_launches} launches, {s_kernel_ms:.2f} ms of kernel time; the tile-score pass "
        f"{sc_ms:.3f} ms against its bound {sc_bound['bound_ms']:.3f} ms "
        f"({sc_bound['bound_by']}: {sc_bound['bytes']} B), "
        f"{sc_bound['bound_ms'] / sc_ms * 100:.1f}% of it")
    del g_copy, Tcws, targets, depths, mean2d, radius, ok
    torch.cuda.empty_cache()
    # one full-size rasterize of the final gaussians, card against CPU
    g_cpu = gs.Gaussians(*[x.detach().cpu() for x in g])
    with torch.no_grad():
        *og, idx_g, _ = gs.rasterize(g, Tcw_t, K_t, rh, rw, vol.tile_k, return_indices=True)
        *oc, idx_c, _ = gs.rasterize(g_cpu, Tcw_t.cpu(), K_t.cpu(), rh, rw, vol.tile_k,
                                        return_indices=True)
        errs = [float((a.detach().cpu() - b).abs().max() / max(float(b.abs().max()), 1e-30))
                for a, b in zip(og, oc)]
        # selections that differ: at near-ties of the tile score (the set)
        # or of the depth (the order), on the CPU's numbers
        m2, _, dep, rad, _, okc = gs.project_gaussians(g_cpu, Tcw_t.cpu(), K_t.cpu())
        cyx_c = gs.tile_centers(rh // gs.TILE, rw // gs.TILE, "cpu")
        idx_g = idx_g.cpu()
        diff_rows = torch.nonzero((idx_g != idx_c).any(1))[:, 0].tolist()
        far = 0
        for t in diff_rows:
            s = gs.tile_scores(cyx_c[t:t + 1], m2, rad, okc)[0]
            sel = s[idx_c[t]]
            kth, scale = float(sel.min()), float(sel.abs().max())
            a, b = set(idx_g[t].tolist()), set(idx_c[t].tolist())
            far += sum(abs(float(s[j]) - kth) > GS_TIE_TOL * scale for j in a ^ b)
            if a == b:
                dg, dc = dep[idx_g[t]], dep[idx_c[t]]
                far += int(((dg - dc).abs() > GS_TIE_TOL * float(dc.abs().max())).sum())
    out.update(card_cpu_rel_errs=errs, rows_apart=len(diff_rows), apart_not_at_ties=far)
    log(f"[gs] full-size rasterize card against CPU: colour, alpha, depth within "
        + ", ".join(f"{e:.3g}" for e in errs) + f" of their largest; {len(diff_rows)} of {n_t} "
        f"tiles select otherwise, {far} selections apart away from a near-tie")
    assert max(errs) <= RECON_TOL and far == 0, out
    del g_cpu, og, oc, integ, vol, slam
    torch.cuda.empty_cache()
    return out


def gs_heldout(dev):
    """Phase 19d: the configuration of the JAX package's own floor
    (tests/test_gaussian_splatting.py::test_gs_integrator_improves_rendering):
    6 keyframes of the 96x128 RGBD line at their ground-truth poses into a
    volume of 20000 gaussians (25 steps, tile_k 32, stride 3), then the
    held-out frame 6 rendered against its image."""
    import torch

    from pyslam_tpu_torch.dense.gaussian_splatting_integrator import GaussianSplattingVolume
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.io.synthetic import SyntheticDataset

    t0 = time.perf_counter()
    ds = SyntheticDataset(num_frames=8, h=96, w=128, sensor_type=SensorType.RGBD,
                          trajectory="line", step=0.15)
    K = np.array([[ds.fx, 0, ds.cx], [0, ds.fy, ds.cy], [0, 0, 1]], np.float32)
    vol = GaussianSplattingVolume(capacity=20_000, steps_per_kf=25, tile_k=32, seed_stride=3,
                                  device=dev)
    for i in range(6):
        vol.integrate(ds.getDepth(i), ds.getImage(i), ds.poses[i], K)
    color, _, _ = vol.render(np.linalg.inv(ds.poses[6]), K)
    rh, rw = vol.render_hw
    target = np.asarray(ds.getImage(6), np.float32)[:rh, :rw] / 255.0
    out = dict(psnr_db=psnr(color[..., 0], target), gaussians=vol.num_used,
               seconds=time.perf_counter() - t0)
    log(f"[gs] the JAX package's held-out configuration (96x128, 6 keyframes, 20000 "
        f"gaussians, 25 steps, tile_k 32, stride 3): frame 6 at {out['psnr_db']:.2f} dB "
        f"(floor {GS_PSNR_MIN}), {vol.num_used} gaussians, {out['seconds']:.1f} s")
    assert out["psnr_db"] > GS_PSNR_MIN and vol.device.type == "cuda", out
    del vol
    torch.cuda.empty_cache()
    return out


def gs_drift(dev):
    """Phase 19d: the drift witness of ``python -m tests.torch_gs_drift`` on
    the card: GS_DRIFT_KEYFRAMES of phase 9's stream at their ground-truth
    poses, rendered at 1/GS_DRIFT_SCALE of its size, into a volume at its
    defaults (depth truncated at GS_DEPTH_TRUNC), driven directly; each
    view's PSNR after its own integration and at the session's end, the
    end's mean held within GS_DRIFT_MARGIN_DB of the JAX package's on the
    CPU."""
    import torch

    from pyslam_tpu_torch.dense.gaussian_splatting_integrator import GaussianSplattingVolume
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.io.synthetic import SyntheticDataset, SyntheticWorld

    t0 = time.perf_counter()
    extent = max(60.0, (N_FRAMES * 0.8 + 30.0) / 1.4)
    world = SyntheticWorld(n_points=16000, extent=extent, depth_range=(4.0, 80.0))
    ds = SyntheticDataset(num_frames=N_FRAMES, h=H // GS_DRIFT_SCALE, w=W // GS_DRIFT_SCALE,
                          fx=FX / GS_DRIFT_SCALE, baseline=BASELINE_M, trajectory="line",
                          step=0.8, sensor_type=SensorType.RGBD, world=world)
    K = np.array([[ds.fx, 0, ds.cx], [0, ds.fy, ds.cy], [0, 0, 1]], np.float64)
    vol = GaussianSplattingVolume(depth_trunc=GS_DEPTH_TRUNC, device=dev)

    def view_psnr(i):
        rh, rw = vol.render_hw
        color = vol.render(np.linalg.inv(ds.poses[i]), K)[0][..., 0]
        return psnr(color, np.asarray(ds.getImage(i), np.float32)[:rh, :rw] / 255.0)

    fitted = []
    for i in GS_DRIFT_KEYFRAMES:
        vol.integrate(ds.getDepth(i), ds.getImage(i), ds.poses[i], K)
        fitted.append(view_psnr(i))
    end = [view_psnr(i) for i in GS_DRIFT_KEYFRAMES]
    out = dict(raster=list(vol.render_hw), gaussians=vol.num_used, fitted_psnr_db=fitted,
               end_psnr_db=end, mean_fitted_db=float(np.mean(fitted)),
               mean_end_db=float(np.mean(end)), jax_cpu_mean_end_db=GS_DRIFT_JAX_END_DB,
               seconds=time.perf_counter() - t0)
    log(f"[gs] drift witness ({len(GS_DRIFT_KEYFRAMES)} keyframes of phase 9's stream at "
        f"1/{GS_DRIFT_SCALE} size, raster {out['raster'][0]}x{out['raster'][1]}, the volume's "
        f"defaults): {vol.num_used} gaussians; PSNR after each keyframe's integration "
        + ", ".join(f"{p:.2f}" for p in fitted) + " dB, at the session's end "
        + ", ".join(f"{p:.2f}" for p in end) + f" dB (means {out['mean_fitted_db']:.2f}, "
        f"{out['mean_end_db']:.2f}; the JAX package's end on the CPU {GS_DRIFT_JAX_END_DB}, "
        f"margin {GS_DRIFT_MARGIN_DB}), {out['seconds']:.1f} s")
    assert vol.device.type == "cuda", out
    assert abs(out["mean_end_db"] - GS_DRIFT_JAX_END_DB) <= GS_DRIFT_MARGIN_DB, out
    del vol
    torch.cuda.empty_cache()
    return out


def dense_entry_phase(dev):
    """Phase 19e: main_map_dense_reconstruction on the card."""
    import tempfile

    from pyslam_tpu_torch import main_map_dense_reconstruction
    from pyslam_tpu_torch.config_parameters import Parameters

    Parameters.kVolumetricIntegrationUseDepthEstimator = False
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "cloud.npz")
        pts, cols = main_map_dense_reconstruction.run(["--frames", str(DENSE_ENTRY_FRAMES),
                                                       "--save_cloud", path])
        with np.load(path) as z:
            reloaded = np.array_equal(z["points"], pts)
    out = dict(points=len(pts), seconds=time.perf_counter() - t0, reloaded=reloaded)
    log(f"[dense-entry] main_map_dense_reconstruction --frames {DENSE_ENTRY_FRAMES} on the card: "
        f"{len(pts)} cloud points in {out['seconds']:.1f} s, the saved npz reloads: {reloaded}")
    assert len(pts) > 0 and np.isfinite(pts).all() and reloaded, out
    return out


def scene_views():
    """19a's SCENE_VIEWS views: every third frame of a small monocular line."""
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.io.synthetic import SyntheticDataset

    ds = SyntheticDataset(num_frames=SCENE_VIEWS * 3, sensor_type=SensorType.MONOCULAR,
                          trajectory="line", step=0.5)
    return [ds.getImage(i * 3) for i in range(SCENE_VIEWS)]


def reconstruction_phase(dev, rgbd_frames, cam_rgbd, ds_rgbd, side=None):
    """Phase 19: 3D reconstruction from views and Gaussian-splatting dense
    mapping; the parts of side_work taken from ``side``, the second
    process's numbers, where it is given."""
    out = {"models": side["recon_models"] if side else recon_models_phase(dev, scene_views())}
    out.update(side["scene"] if side else scene_phase(dev))
    out["gs"] = gs_phase(dev, rgbd_frames[:GS_FRAMES], cam_rgbd, ds_rgbd)
    for key, run in (("gs_heldout", gs_heldout), ("gs_drift", gs_drift),
                     ("dense_entry", dense_entry_phase)):
        out[key] = side[key] if side else run(dev)
    return out


def write_kitti_sequence(root, frames, ds):
    """Phase 7's stereo frames as a KITTI odometry sequence 00 under
    ``root`` (uint8 PNGs as bench.py's frame cache stores them, times.txt,
    the ground truth as poses/00.txt), an ORB-SLAM settings yaml with the
    main stage's camera and a config.yaml naming them; returns the
    config's path."""
    import yaml
    from PIL import Image

    seq = os.path.join(root, "sequences", "00")
    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(seq, sub), exist_ok=True)
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)
    for i, (left, right, _) in enumerate(frames):
        for sub, img in (("image_0", left), ("image_1", right)):
            Image.fromarray(np.asarray(img).astype(np.uint8)).save(
                os.path.join(seq, sub, f"{i:06d}.png"), compress_level=1)
    np.savetxt(os.path.join(seq, "times.txt"), [ts for _, _, ts in frames], fmt="%.6e")
    np.savetxt(os.path.join(root, "poses", "00.txt"),
               ds.poses[:len(frames), :3, :].reshape(len(frames), 12), fmt="%.12e")
    bf = FX * BASELINE_M
    settings = {"Camera.fx": FX, "Camera.fy": FX, "Camera.cx": ds.cx, "Camera.cy": ds.cy,
                "Camera.k1": 0.0, "Camera.k2": 0.0, "Camera.p1": 0.0, "Camera.p2": 0.0,
                "Camera.k3": 0.0, "Camera.width": W, "Camera.height": H, "Camera.fps": ds.fps,
                "Camera.bf": bf, "ThDepth": ENTRY_DEPTH_THRESHOLD * FX / bf,
                "ORBextractor.nFeatures": N_FEATURES, "ORBextractor.scaleFactor": 1.2,
                "ORBextractor.nLevels": N_LEVELS}
    with open(os.path.join(root, "settings.yaml"), "w") as f:
        f.write("%YAML:1.0\n" + yaml.safe_dump(settings))
    cfg = {"DATASET": {"type": "KITTI"},
           "KITTI": {"type": "kitti", "base_path": root, "name": "00", "sensor_type": "stereo",
                     "settings": "settings.yaml", "groundtruth_file": "poses/00.txt",
                     "FeatureTrackerConfig.name": "ORB2", "LoopDetectionConfig.name": "DBOW3"},
           # the main stage's dense configuration (bench.py:126-155)
           "GLOBAL_PARAMETERS": {"kVolumetricIntegrationVoxelSize": VOXEL_SIZE,
                                 "kVolumetricIntegrationSdfTrunc": SDF_TRUNC,
                                 "kVolumetricIntegrationDepthTruncOutdoor": DEPTH_TRUNC_OUTDOOR,
                                 "kVolumetricIntegrationDepthEstimatorType": "sgbm"}}
    path = os.path.join(root, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def entry_phase(dev, frames, ds, keep_state=None):
    """Phase 13: main_slam on a KITTI sequence written to disk, then the
    saved state reloaded and relocalised in; returns its numbers.  With
    ``keep_state``, the saved state is copied there (phase 21 reads it)."""
    import shutil
    import tempfile

    import torch

    from pyslam_tpu_torch import main_slam
    from pyslam_tpu_torch.config import Config
    from pyslam_tpu_torch.config_parameters import Parameters
    from pyslam_tpu_torch.dense.volumetric_integrator import (
        VolumetricIntegratorType, volumetric_integrator_factory)
    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfigs
    from pyslam_tpu_torch.io.dataset import KittiDataset
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.io.ground_truth import read_kitti_poses
    from pyslam_tpu_torch.ops.fast import fast_nms
    from pyslam_tpu_torch.slam.slam import Slam
    from pyslam_tpu_torch.slam.tracking import TrackingState

    saved = Parameters.as_dict()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kitti_") as root:
        t0 = time.perf_counter()
        cfg_path = write_kitti_sequence(root, frames, ds)
        log(f"[entry] wrote {len(frames)} stereo frames {H}x{W} as a KITTI sequence in "
            f"{time.perf_counter() - t0:.1f} s")
        state = os.path.join(root, "state")
        traj = os.path.join(root, "trajectory_kitti.txt")
        # ---- 13a: the entry point on the card (its default device)
        torch.cuda.synchronize()
        fast_nms.launches = 0
        t0 = time.perf_counter()
        rc = main_slam.main(["--config", cfg_path, "--volumetric", "--save_state", state,
                             "--save_trajectory", traj, "--trajectory_format", "kitti"])
        torch.cuda.synchronize()
        launches = fast_nms.launches
        t_main = time.perf_counter() - t0
        with open(os.path.join(state, "other_metrics_info.txt")) as f:
            metrics = json.load(f)
        with open(os.path.join(state, "config_info.json")) as f:
            info = json.load(f)
        # the KITTI rows carry no timestamps: main_slam's ATE is the
        # trajectory's against read_kitti_poses of the ground-truth file
        est = read_kitti_poses(traj)
        ate = float(metrics["ate_rmse"])
        n_ok = metrics["num_frames"] - metrics["num_lost"]
        files = sorted(os.listdir(state))
        z = np.load(os.path.join(state, "volumetric_state.npz"))
        load = float(z["occupied"].mean())
        voc_checksum = str(np.load(os.path.join(state, "loop_closing_state.npz"))["voc_checksum"])
        log(f"[entry] main_slam --config (KITTI 00, {len(frames)} frames {H}x{W}, ORB2 "
            f"{N_FEATURES} features on {N_LEVELS} levels, DBOW3, TSDF with SGM depth) on "
            f"the card: exit {rc} in {t_main:.1f} s; {n_ok}/{metrics['num_frames']} tracked "
            f"(OK after the frame), {metrics['num_tracked']} in the final trajectory (a frame "
            f"whose reference keyframe was culled is left out, as in the reference), "
            f"{metrics['loops_closed']} loops closed, {info['num_keyframes']} keyframes, "
            f"{info['num_points']} points; {metrics['fps_from_frame_10']:.2f} FPS over frames "
            f"10-{len(frames) - 1} (incl. final drain), latency p50 "
            f"{metrics['frame_ms_p50']:.1f} ms p95 {metrics['frame_ms_p95']:.1f} ms; ATE "
            f"{ate:.4f} m against read_kitti_poses; fast_nms launches {launches}; "
            f"table load factor {load:.4f} after {metrics['volumetric_integrated']} of "
            f"{metrics['volumetric_keyframes']} keyframes handed over integrated "
            f"({info['num_keyframes']} keyframes in the map, {metrics['loops_closed']} loops "
            f"closed); state files {files}")
        log("[entry] stage totals: " + json.dumps(
            {mod: {k: round(v, 1) for k, v in st.items()}
             for mod, st in metrics["stage_totals_ms"].items()}))
        assert rc == 0, rc
        assert n_ok == len(frames), f"{n_ok}/{len(frames)} tracked"
        assert len(est) == metrics["num_tracked"] and np.isfinite(est.Twc).all(), len(est)
        assert ate < ENTRY_ATE_MAX, ate
        assert launches == len(frames), f"{launches} fast_nms launches for {len(frames)} frames"
        for name in ("map.json", "config_info.json", "loop_closing_state.npz",
                     "volumetric_state.npz"):
            assert name in files, (name, files)
        if keep_state is not None:
            shutil.copytree(state, keep_state)

        # ---- 13b: a fresh session on the card reloads the state
        cfg = Config(cfg_path)   # the same camera and dense flags
        cam = cfg.camera
        tracker_cfg = dataclasses.replace(FeatureTrackerConfigs.get("ORB2"),
                                          num_features=N_FEATURES)
        t0 = time.perf_counter()
        slam = Slam(cam, tracker_cfg, loop_detector_config="DBOW3",
                    sensor_type=SensorType.STEREO, device=dev)
        integ = volumetric_integrator_factory(VolumetricIntegratorType.TSDF, camera=cam,
                                              environment_type=type("E", (), {"name": "OUTDOOR"})(),
                                              device=dev)
        slam.set_volumetric_integrator(integ)
        slam.load_system_state(state)
        t_load = time.perf_counter() - t0
        voc = slam.loop_closing.detector.vocabulary
        kf = slam.map.last_keyframe()
        assert slam.map.num_keyframes() == info["num_keyframes"], \
            (slam.map.num_keyframes(), info)
        assert slam.map.num_points() == info["num_points"], (slam.map.num_points(), info)
        assert slam.state == TrackingState.INIT_RELOCALIZE, slam.state
        assert voc.checksum() == voc_checksum, (voc.checksum(), voc_checksum)
        assert (slam.map.device.type == "cuda" and kf.dev("des").device.type == "cuda"
                and voc._dev[0].device.type == "cuda"
                and integ.volume.table.tsdf.device.type == "cuda")
        kitti = KittiDataset(root, "00")
        last = len(frames) - 1
        dropped, valid = keyframe_drops(integ.volume, integ._depth_provider, cam,
                                        kitti.getImage(last), kitti.getImageRight(last),
                                        ds.poses[last])
        drop = dropped / max(valid, 1)
        voxels_per_frame = frame_voxels(integ.volume, integ._depth_provider, cam,
                                        [(kitti.getImage(i), kitti.getImageRight(i), 0)
                                         for i in range(len(frames))], ds.poses[:len(frames)])
        table = check_table(integ.volume.table, metrics["volumetric_integrated"],
                            voxels_per_frame, drop)
        log(f"[entry] reloaded into a fresh Slam on the card in {t_load:.1f} s: "
            f"{slam.map.num_keyframes()} keyframes, {slam.map.num_points()} points, state "
            f"{slam.state.name}, vocabulary checksum {voc.checksum()} (saved {voc_checksum}), "
            f"{integ.volume.num_voxels()} voxels, load factor {table['load']:.4f} (ceiling "
            f"{table['load_ceiling']:.4f} for {table['integrated']} keyframes integrated); "
            f"probe sequences: {table['beyond']} keys beyond the claim rounds, "
            f"{table['holes']} holes, {table['duplicates']} duplicates, {table['aliases']} "
            f"fingerprint aliases, displacement <= {table['max_displacement']}; a keyframe of "
            f"the last frame would leave {dropped} of its {valid} valid updates "
            f"({drop * 100:.3f}%, ceiling {DROP_MAX * 100:.0f}%) dropped")
        states = []
        for i in range(ENTRY_RELOC_FRAMES[0], ENTRY_RELOC_FRAMES[1]):
            slam.track(kitti.getImage(i), img_right=kitti.getImageRight(i), frame_id=100 + i,
                       timestamp=10.0 + kitti.getTimestamp(i))
            states.append(slam.state.name)
            if slam.state != TrackingState.OK:
                log(f"[entry] frame {i} not relocalised: candidates (kid, matches, PnP "
                    f"inliers, final inliers) {slam.loop_closing.relocalizer.trace}")
        first_ok = states.index("OK") if "OK" in states else None
        log(f"[entry] frames {ENTRY_RELOC_FRAMES[0]}-{ENTRY_RELOC_FRAMES[1] - 1} of the "
            f"sequence fed to the reloaded session: {' '.join(states)}")
        assert first_ok is not None and first_ok < ENTRY_RELOC_WITHIN, states
        assert all(st == "OK" for st in states[first_ok:]), states
        del slam, integ
        # the same map in the reference's schema, through two fresh sessions
        ref_state = os.path.join(root, "state_reference")
        slam = Slam(cam, tracker_cfg, loop_detector_config="DBOW3",
                    sensor_type=SensorType.STEREO, device=dev)
        slam.load_system_state(state)
        slam.save_system_state(ref_state, schema="reference")
        slam = Slam(cam, tracker_cfg, loop_detector_config="DBOW3",
                    sensor_type=SensorType.STEREO, device=dev)
        slam.load_system_state(ref_state)
        log(f"[entry] reference schema: {slam.map.num_keyframes()} keyframes, "
            f"{slam.map.num_points()} points after a save and a reload")
        assert slam.map.num_keyframes() == info["num_keyframes"], slam.map.num_keyframes()
        assert slam.map.num_points() == info["num_points"], slam.map.num_points()
        assert slam.map.device.type == "cuda"
        del slam
        out = {"launches": launches, "n_tracked": n_ok, "trajectory_rows": len(est), "ate": ate,
               "loops_closed": metrics["loops_closed"], "fps": metrics["fps_from_frame_10"],
               "p50_ms": metrics["frame_ms_p50"], "p95_ms": metrics["frame_ms_p95"],
               "keyframes": info["num_keyframes"], "points": info["num_points"],
               "load_factor": load, "load_ceiling": table["load_ceiling"],
               "integrated": table["integrated"], "drop_share": drop, "reloc_states": states,
               "main_s": t_main, "load_s": t_load}
    Parameters.set_from_dict(saved)
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ phase 20
def _grads_card_vs_cpu(dev, make):
    """make(device) -> (params, loss function) from the same seed and batch;
    the relative errors of the card's loss and gradient against the CPU's."""
    import torch

    out = []
    for d in (dev, torch.device("cpu")):
        params, loss_fn = make(d)
        loss = loss_fn()
        grads = torch.autograd.grad(loss, list(params.values()))
        flat = torch.cat([g.detach().reshape(-1).cpu() for g in grads])
        out.append((float(loss.detach()), flat))
    (lg, gg), (lc, gc) = out
    return abs(lg - lc) / max(abs(lc), 1e-30), float((gg - gc).abs().max() / gc.abs().max())


def _superpoint_floors(dev, path):
    """tests/test_superpoint_trained.py's floors on the port's extractor."""
    from pyslam_tpu_torch.models import train_superpoint as tsp
    from pyslam_tpu_torch.models.superpoint import SuperPointExtractor

    def scene(seed):
        rng = np.random.default_rng(seed)
        img, corners = tsp.render_shapes(rng)
        while len(corners) < 8:
            img, corners = tsp.render_shapes(rng)
        return img, corners

    def detect(ex, img, k):
        fd = ex(img)
        xy, resp, valid = (fd.xy.cpu().numpy(), fd.response.cpu().numpy(),
                           fd.valid.cpu().numpy())
        order = np.argsort(-np.where(valid, resp, -np.inf))[:k]
        return xy[order], fd.desc.cpu().numpy()[order]

    def precision(xy, corners):
        d = np.linalg.norm(xy[:, None, :] - corners[None, :, :], axis=-1)
        return float((d.min(axis=1) <= 4.0).mean())

    ex = SuperPointExtractor(num_features=300, checkpoint=path, device=dev)
    raw = SuperPointExtractor(num_features=300, checkpoint="", device=dev)   # random
    assert ex.trained and not raw.trained
    img, corners = scene(12345)
    prec = precision(detect(ex, img, 40)[0], corners)
    prec_r = precision(detect(raw, img, 40)[0], corners)
    img, _ = scene(54321)
    hm = tsp.random_homography(np.random.default_rng(7))
    xy1, d1 = detect(ex, img, 80)
    xy2, d2 = detect(ex, tsp.warp_image(img, hm), 80)
    sim = d1 @ d2.T
    a2b, b2a = sim.argmax(1), sim.argmax(0)
    mutual = b2a[a2b] == np.arange(len(xy1))
    proj = tsp.warp_points(xy1, hm)
    sel = mutual & (proj[:, 0] >= 0) & (proj[:, 0] < tsp.W) & (proj[:, 1] >= 0) \
        & (proj[:, 1] < tsp.H)
    inl = float((np.linalg.norm(xy2[a2b[sel]] - proj[sel], axis=1) <= 6.0).mean()) \
        if sel.any() else 0.0
    return {"corner_precision": prec, "corner_precision_random": prec_r,
            "mutual_matches": int(sel.sum()), "descriptor_inliers": inl}


def trainer_phase(dev):
    """Phase 20a: the three trainers on the card."""
    import tempfile

    import torch

    from pyslam_tpu_torch import interop
    from pyslam_tpu_torch.models import train_cosplace as tcp
    from pyslam_tpu_torch.models import train_lightglue as tlg
    from pyslam_tpu_torch.models import train_superpoint as tsp
    from pyslam_tpu_torch.models.cosplace import CosPlaceExtractor
    from pyslam_tpu_torch.models.lightglue import LightGlueMatcher
    from pyslam_tpu_torch.models.resnet import trainable_statistics_
    from pyslam_tpu_torch.ops import adam

    # one step's batch of each (SuperPoint's cut to 2 pairs for the CPU's sake)
    sp_batch = [torch.from_numpy(a) for a in tsp.make_batch(np.random.default_rng(1), 2)]
    sp_batch[1], sp_batch[3] = sp_batch[1].long(), sp_batch[3].long()
    lg_batch = [torch.from_numpy(a) for a in tlg.make_batch(np.random.default_rng(1), 16,
                                                             tlg.N_POOL)]
    r = np.random.default_rng(1)
    labels = r.integers(0, tcp.N_PLACES, 32)
    tex = {lb: tcp.place_texture(1000 + lb) for lb in set(labels.tolist())}
    cp_x = torch.from_numpy(np.stack([tcp._normalize(tcp.render_view(tex[lb], r))
                                      for lb in labels])).permute(0, 3, 1, 2).contiguous()
    cp_y = torch.from_numpy(labels)
    cp_centers = torch.randn((tcp.N_PLACES, tcp.OUT_DIM),
                             generator=torch.Generator().manual_seed(1)) * 0.05
    # CosPlace's trainer samples its views on the card: identical to
    # render_view (the JAX package's numpy code, copied) on the host
    keys = sorted(tex)
    views = tcp.normalized_views(torch.from_numpy(np.stack([tex[k] for k in keys])).to(dev),
                                 [keys.index(lb) for lb in labels],
                                 np.random.default_rng(3)).cpu().numpy()
    r = np.random.default_rng(3)
    same_views = np.array_equal(views, np.stack([tcp._normalize(tcp.render_view(tex[lb], r))
                                                 for lb in labels]))
    log(f"[train] CosPlace's {len(labels)} views of a step sampled on the card "
        f"{'identical to' if same_views else 'DIFFER from'} render_view on the host")
    assert same_views

    def make(name, d):
        """(params, loss function) of one step of ``name`` on device d, from
        seeded weights and a fixed batch."""
        if name == "superpoint":
            from pyslam_tpu_torch.models.superpoint import SuperPointNet

            net = interop.seeded_init_(SuperPointNet(), 0).to(d)
            batch = [a.to(d) for a in sp_batch]
            return dict(net.named_parameters()), lambda: tsp.batch_loss(net, *batch)[0]
        if name == "lightglue":
            net = interop.seeded_init_(tlg.build_net(), 0).to(d)
            params = dict(net.named_parameters())
            batch = [a.to(d) for a in lg_batch]
            return params, lambda: tlg.batch_loss(net, params, *batch)
        net = trainable_statistics_(interop.seeded_init_(tcp.build_net(), 0)).to(d)
        centers = cp_centers.to(d).requires_grad_(True)
        params = {f"net.{n}": p for n, p in net.named_parameters()}
        params["centers"] = centers
        x, y = cp_x.to(d), cp_y.to(d)
        return params, lambda: tcp.batch_loss(net, centers, x, y)

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, mod, steps in (("superpoint", tsp, SP_STEPS), ("cosplace", tcp, CP_STEPS),
                                 ("lightglue", tlg, LG_STEPS)):
            loss_err, grad_err = _grads_card_vs_cpu(dev, lambda d: make(name, d))
            params, loss_fn = make(name, dev)
            state = adam.init_state(params)
            clip = 1.0 if name == "lightglue" else None

            def step():
                adam.minimise_step_(params, loss_fn(), state, 1e-3, clip)

            step()   # warm-up (the autotuned algorithms, the caching allocator)
            n_launch, k_ms = profile_call(step)
            del params, loss_fn, state
            losses = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "superpoint":
                state_dict = mod.train(steps=steps, device=dev, losses=losses, log_every=500,
                                       indices=np.load(SP_REFERENCE_DRAWS).astype(np.int64))
            else:
                _, state_dict = mod.train(steps=steps, device=dev, losses=losses,
                                          log_every=max(steps // 3, 1))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            curve = torch.stack(losses).cpu().numpy()
            curve = curve[:, 0] if curve.ndim == 2 else curve
            path = os.path.join(tmp, f"{name}.npz")
            mod.save_checkpoint(path, state_dict)
            row = {"loss_rel_err": loss_err, "grad_rel_err": grad_err, "step_launches": n_launch,
                   "step_kernel_ms": k_ms, "steps": steps, "train_s": wall,
                   "ms_per_step": wall / steps * 1e3, "loss_first": float(curve[0]),
                   "loss_last": float(curve[-1])}
            if name == "superpoint":
                row.update(_superpoint_floors(dev, path))
                ok = (row["corner_precision"] >= 0.5
                      and row["corner_precision"] >= row["corner_precision_random"] + 0.2
                      and row["mutual_matches"] >= 10 and row["descriptor_inliers"] >= 0.5)
            elif name == "cosplace":
                ex = CosPlaceExtractor(checkpoint=path, image_hw=(tcp.VIEW_H, tcp.VIEW_W),
                                       device=dev)
                assert ex.trained
                row["recall_at_1"] = tcp.evaluate(ex.net, n_places=16)
                row["recall_at_1_random"] = tcp.evaluate(
                    interop.seeded_init_(tcp.build_net(), 0).to(dev), n_places=16)
                ok = (row["recall_at_1"] >= 0.75
                      and row["recall_at_1"] > row["recall_at_1_random"] + 0.2)
            else:
                m = LightGlueMatcher(dim=tlg.DIM, layers=tlg.LAYERS, checkpoint=path, device=dev)
                assert m.trained
                row["precision"], row["recall"] = tlg.evaluate(m.net, n_pairs=20)
                row["nn_precision"], row["nn_recall"] = tlg.nn_baseline(n_pairs=20)
                w = min(LG_LOSS_WINDOW, len(curve) // 2)
                row["loss_first_mean"] = float(curve[:w].mean())
                row["loss_last_mean"] = float(curve[-w:].mean())
                floors = (row["precision"] >= 0.38 and row["recall"] >= 0.30
                          and row["precision"] > row["nn_precision"] + 0.08
                          and row["recall"] > row["nn_recall"] + 0.08)
                row["floors_met"] = floors
                ok = floors if steps >= 6000 else row["loss_last_mean"] < row["loss_first_mean"]
            out[name] = row
            log(f"[train] {name}: card against CPU loss {loss_err:.2e}, gradient "
                f"{grad_err:.2e} of the largest; one step {n_launch} launches, "
                f"{k_ms:.3f} kernel ms; {steps} steps in {wall:.1f} s "
                f"({row['ms_per_step']:.2f} ms a step), loss {row['loss_first']:.4f} -> "
                f"{row['loss_last']:.4f}; " + ", ".join(
                    f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in row.items() if k not in (
                        "loss_rel_err", "grad_rel_err", "step_launches", "step_kernel_ms",
                        "steps", "train_s", "ms_per_step", "loss_first", "loss_last")))
            assert loss_err <= TRAIN_GRAD_TOL and grad_err <= TRAIN_GRAD_TOL, (name, row)
            assert np.isfinite(curve).all(), name
            assert ok, (name, row)
    return out


def large_ba_phase(dev, frames, cam):
    """Phase 20b: phase 7's stream with the periodic large-window BA."""
    import torch

    from pyslam_tpu_torch.config_parameters import Parameters
    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.ops.fast import fast_nms
    from pyslam_tpu_torch.slam.slam import Slam

    slam = Slam(cam, FeatureTrackerConfig(num_features=N_FEATURES, num_levels=N_LEVELS),
                sensor_type=SensorType.STEREO, device=dev)
    lm = slam.local_mapping
    windows = []
    dispatch = lm._lba_dispatch

    def spy(kf, window_size=None):
        windows.append(window_size)
        dispatch(kf, window_size=window_size)

    lm._lba_dispatch = spy
    saved = (Parameters.kUseLargeWindowBA, Parameters.kEveryNumFramesLargeWindowBA)
    Parameters.kUseLargeWindowBA, Parameters.kEveryNumFramesLargeWindowBA = True, 2
    fast_nms.launches = 0
    t0 = time.perf_counter()
    try:
        for i, (img_l, img_r, ts) in enumerate(frames):
            slam.track(img_l, img_right=img_r, frame_id=i, timestamp=ts)
            lm.finish()   # drained every frame, as the reference's test
        slam.finish()
    finally:
        Parameters.kUseLargeWindowBA, Parameters.kEveryNumFramesLargeWindowBA = saved
    torch.cuda.synchronize()
    large = [w for w in windows if w is not None]
    out = {"frames": len(frames), "n_tracked": len(slam.tracking.history.timestamps),
           "keyframes_handed_off": lm._kf_count, "lba_dispatches": len(windows),
           "large_dispatches": len(large), "launches": fast_nms.launches,
           "seconds": time.perf_counter() - t0}
    log(f"[large-ba] {out['n_tracked']}/{len(frames)} tracked, {lm._kf_count} keyframes "
        f"handed off, {len(large)} large-window dispatches (window "
        f"{Parameters.kLargeBAWindowSize}) among {len(windows)} LBA dispatches, fast_nms "
        f"launches {fast_nms.launches}, {out['seconds']:.1f} s")
    assert out["n_tracked"] == len(frames), out
    assert large and all(w == Parameters.kLargeBAWindowSize for w in large), windows
    assert fast_nms.launches == len(frames), out
    return out, slam


def bag_phase(dev, frames, cam):
    """Phase 20c: a ROS 2 bag of the stream, read back into Slam.track()."""
    import tempfile

    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
    from pyslam_tpu_torch.io.dataset_factory import dataset_factory
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.io.ros2bag import Ros2BagWriter, encode_image
    from pyslam_tpu_torch.ops.fast import fast_nms
    from pyslam_tpu_torch.slam.slam import Slam

    topics = {"topic": "/cam0/image_raw", "right_topic": "/cam1/image_raw"}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stream.db3")
        t0 = time.perf_counter()
        w = Ros2BagWriter(path)
        for topic in topics.values():
            w.add_topic(topic, "sensor_msgs/msg/Image")
        for img_l, img_r, ts in frames:
            for topic, img in zip(topics.values(), (img_l, img_r)):
                w.write(topic, int(round(ts * 1e9)), encode_image(img, ts, encoding="32FC1"))
        w.close()
        size = os.path.getsize(path)
        ds = dataset_factory(dict(topics, type="ros2bag", base_path=path, sensor_type="stereo"))
        got = [(ds.getImage(i), ds.getImageRight(i), ds.getTimestamp(i))
               for i in range(ds.num_frames)]
        io_s = time.perf_counter() - t0
    assert len(got) == len(frames) and ds.sensor_type == SensorType.STEREO
    same = all(np.array_equal(a, c) and np.array_equal(b, d) and abs(t - u) < 1e-6
               for (a, b, t), (c, d, u) in zip(got, frames))
    slam = Slam(cam, FeatureTrackerConfig(num_features=N_FEATURES, num_levels=N_LEVELS),
                sensor_type=SensorType.STEREO, device=dev)
    fast_nms.launches = 0
    for i, (img_l, img_r, ts) in enumerate(got):
        slam.track(img_l, img_right=img_r, frame_id=i, timestamp=ts)
    slam.finish()
    out = {"frames": len(got), "bag_bytes": size, "write_read_s": io_s, "identical": same,
           "n_tracked": len(slam.tracking.history.timestamps), "launches": fast_nms.launches}
    log(f"[bag] a ROS 2 bag of {len(frames)} stereo frames ({size} B) written and read back "
        f"through dataset_factory in {io_s:.2f} s, images "
        f"{'identical' if same else 'DIFFER'}; Slam.track on the card "
        f"{out['n_tracked']}/{len(got)} tracked, fast_nms launches {fast_nms.launches}")
    assert same and out["n_tracked"] == len(got) and fast_nms.launches == len(got), out
    return out


def viewer_phase(slam):
    """Phase 20d: the HTML export and one live-viewer poll of slam's map."""
    import tempfile
    import urllib.request

    from pyslam_tpu_torch.viz.html_viewer import export_html_map
    from pyslam_tpu_torch.viz.live_viewer import LiveViewer3D

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = export_html_map(slam, os.path.join(tmp, "map.html"))
        html = open(path).read()
    export_s = time.perf_counter() - t0
    viewer = LiveViewer3D(port=0)
    try:
        viewer.update(slam, status="phase 20d", force=True)
        with urllib.request.urlopen(viewer.url + "/state.json?v=-1", timeout=10) as r:
            st = json.loads(r.read())
    finally:
        viewer.close()
    scene = st["scene"]
    out = {"html_bytes": len(html), "export_s": export_s, "poll_version": st["version"],
           "n_kfs": scene["n_kfs"], "points": len(scene["points"]),
           "traj": len(scene["traj"])}
    log(f"[viewer] HTML export {len(html)} B in {export_s:.2f} s; /state.json version "
        f"{st['version']}: {scene['n_kfs']} keyframes, {len(scene['points'])} points, "
        f"{len(scene['traj'])} trajectory poses")
    assert "frustumSegs" in html and st["status"] == "phase 20d", out
    assert scene["n_kfs"] == slam.map.num_keyframes() >= 2 and scene["points"], out
    return out


# ------------------------------------------------------------------ phase 21
def reload_state(dev, state, cam):
    """Phase 13's saved map in a fresh stereo Slam on the card (ORB2, 2000
    features, no loop closing)."""
    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfigs
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.slam.slam import Slam

    cfg = dataclasses.replace(FeatureTrackerConfigs.get("ORB2"), num_features=N_FEATURES)
    slam = Slam(cam, cfg, sensor_type=SensorType.STEREO, device=dev)
    slam.load_system_state(state)
    return slam


def host_ms(fn, items):
    """Mean host ms of fn over items."""
    t0 = time.perf_counter()
    for x in items:
        fn(x)
    return (time.perf_counter() - t0) * 1e3 / max(len(items), 1)


def native_phase(dev, state, cam):
    """21a: the native mirror of a reloaded full-width map against its
    dicts, and the host time of its two consumers through each."""
    from pyslam_tpu_torch import native
    from pyslam_tpu_torch.config_parameters import Parameters

    slam = reload_state(dev, state, cam)
    m = slam.map
    obs = {p: o for p, o in m.observations.items() if o}
    total = sum(len(o) for o in obs.values())
    pids = np.asarray(sorted(obs), np.int64)
    mirror = m.collect_observations(pids)
    plain = m.collect_observations_plain(pids)
    same = set(zip(*(a.tolist() for a in mirror))) == set(zip(*(a.tolist() for a in plain)))
    kfs = [m.keyframes[k] for k in m.keyframe_order]
    counts = [(kf.points[kf.points >= 0], kf.kid) for kf in kfs]
    windows = []
    for kf in kfs:
        kids = [k for k in [kf.kid] + kf.ordered_covisibles(Parameters.kLocalBAWindowSize)
                if k in m.keyframes]
        windows.append((m.get_local_map_points(kids), kids, {k: i for i, k in enumerate(kids)}))
    out = {"build_s": native.build_seconds, "total_observations": total,
           "mirror_total": m._native.total_observations(), "edges": len(mirror[0]),
           "edges_equal_as_sets": same, "keyframes": len(kfs), "points": len(pids),
           "count_mirror_ms": host_ms(lambda a: m.covisibility_counts(*a), counts),
           "count_plain_ms": host_ms(lambda a: m.covisibility_counts_plain(*a), counts),
           "update_connections_ms": host_ms(m.update_connections, kfs),
           "lba_points_mean": float(np.mean([len(w[0]) for w in windows])),
           "lba_dump_mirror_ms": host_ms(lambda w: m.collect_observations(w[0]), windows),
           "lba_dump_plain_ms": host_ms(lambda w: m.collect_observations_plain(w[0]), windows),
           "lba_assembly_ms": host_ms(
               lambda w: slam.local_mapping._collect_ba_observations(w[0], w[2], w[1]),
               windows)}
    out["in_sync"] = bool(out["mirror_total"] == total == out["edges"] and same)
    build = "built in another process" if out["build_s"] is None else f"{out['build_s']:.2f} s"
    log(f"[native] g++ build {build}; phase 13's map reloaded: {len(kfs)} keyframes, "
        f"{len(pids)} points, {total} observations in the dicts, {out['mirror_total']} in the "
        f"mirror, its edge list {out['edges']} rows {'equal' if same else 'NOT EQUAL'} to the "
        f"dict loop's as a set; mean host ms over the keyframes: covisibility counting "
        f"{out['count_mirror_ms']:.3f} through the mirror, {out['count_plain_ms']:.3f} through "
        f"the dict loop, a whole update_connections {out['update_connections_ms']:.3f}; an LBA "
        f"window's edge dump ({out['lba_points_mean']:.0f} points) {out['lba_dump_mirror_ms']:.3f}"
        f" through the mirror, {out['lba_dump_plain_ms']:.3f} through the dict loop, its whole "
        f"edge assembly {out['lba_assembly_ms']:.3f}")
    del slam
    return out


def sharded_gba_phase(dev, state, cam):
    """21b: the full-width map's GBA unsharded (twice), and sharded over four
    shards on the card and over make_mesh(); the solves' times, launches
    and the sharded runs' reduction bytes."""
    import torch

    from pyslam_tpu_torch.ops import optim
    from pyslam_tpu_torch.parallel.mesh import Mesh, make_mesh
    from pyslam_tpu_torch.parallel.sharded_ba import bundle_adjust_sharded
    from pyslam_tpu_torch.slam.global_bundle_adjustment import (build_full_problem,
                                                                global_bundle_adjustment)

    meshes = {"unsharded": None, "unsharded again": None,
              "Mesh([cuda:0] * 4)": Mesh([dev] * 4), "make_mesh()": make_mesh()}
    slam = reload_state(dev, state, cam)
    problem, kids, pids = build_full_problem(slam.map, cam, slam.feature_tracker, device=dev)
    C, P, O = problem.poses.shape[0], problem.points.shape[0], problem.uv.shape[0]
    del slam
    out = {"P": P, "C": C, "O": O, "iters": SHARD_GBA_ITERS, "variants": {}}
    maps = {}
    for name, mesh in meshes.items():
        if name == "unsharded again":
            solve = None
        elif mesh is None:
            def solve():
                return optim.bundle_adjust(problem, iters=SHARD_GBA_ITERS)
        else:
            def solve(mesh=mesh, traffic=None):
                return bundle_adjust_sharded(problem, iters=SHARD_GBA_ITERS, mesh=mesh,
                                             traffic=traffic)
        row = {}
        if solve is not None:
            solve()
            torch.cuda.synchronize()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                solve()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            row["ms"] = statistics.median(times)
            row["launches"], row["kernel_ms"] = profile_call(solve)
            if mesh is not None:
                traffic = {}
                solve(traffic=traffic)
                row["reduce_bytes"], row["broadcast_bytes"] = traffic["reduce"], \
                    traffic["broadcast"]
                row["devices"] = [str(d) for d in mesh.devices]
        s2 = reload_state(dev, state, cam)
        cost = global_bundle_adjustment(s2.map, cam, s2.feature_tracker, iters=SHARD_GBA_ITERS,
                                        use_sharded=mesh is not None, mesh=mesh, device=dev)
        row["cost"] = cost
        maps[name] = (np.stack([s2.map.keyframes[k].Tcw for k in kids]),
                      s2.map.points.pos[pids].copy())
        del s2
        out["variants"][name] = row
    # the reference's tolerances are a float64 test's (tests/test_parallel.py
    # runs x64): the same full-width problem in float64, unsharded and sharded
    fields = ("poses", "points", "uv", "ur", "sigma2", "K", "bf")
    p64 = problem._replace(**{f: getattr(problem, f).double() for f in fields})
    f64 = {"unsharded": optim.bundle_adjust(p64, iters=SHARD_GBA_ITERS)}
    for name, mesh in meshes.items():
        if mesh is not None:
            f64[name] = bundle_adjust_sharded(p64, iters=SHARD_GBA_ITERS, mesh=mesh)
    out["float64"] = {}
    for name, res in f64.items():
        row = {"pose_err": float((res[0] - f64["unsharded"][0]).abs().max()),
               "point_err": float((res[1] - f64["unsharded"][1]).abs().max()),
               "cost": float(res[2])}
        out["float64"][name] = row
        log(f"[sharded-gba] float64, {name}: against the unsharded float64 solve poses "
            f"{row['pose_err']:.3g}, points {row['point_err']:.3g}, final cost {row['cost']:.8g}")
    ref_poses, ref_points = maps["unsharded"]
    scale = np.maximum(np.abs(ref_points), 1.0)
    for name, (poses, points) in maps.items():
        row = out["variants"][name]
        row["pose_err"] = float(np.abs(poses - ref_poses).max())
        row["pose_rel_err"] = float((np.abs(poses - ref_poses)
                                     / np.maximum(np.abs(ref_poses), 1.0)).max())
        row["point_err"] = float(np.abs(points - ref_points).max())
        row["point_rel_err"] = float((np.abs(points - ref_points) / scale).max())
        extra = ""
        if "ms" in row:
            extra = f"{row['ms']:.1f} ms a solve, {row['launches']} launches, " \
                    f"{row['kernel_ms']:.1f} ms of kernels"
        if "reduce_bytes" in row:
            extra += f", reductions {row['reduce_bytes']} B and broadcasts " \
                     f"{row['broadcast_bytes']} B between the shards over {row['devices']}"
        log(f"[sharded-gba] {name}: {extra + '; ' if extra else ''}against the unsharded "
            f"solve: poses {row['pose_err']:.3g} ({row['pose_rel_err']:.3g} of max(|T|, 1)), "
            f"points {row['point_err']:.3g} "
            f"({row['point_rel_err']:.3g} of max(|x|, 1 m)), final cost {row['cost']:.6g}")
    log(f"[sharded-gba] P {P} points, C {C} keyframes, O {O} observations, "
        f"{SHARD_GBA_ITERS} LM iterations; one card: the four shards share cuda:0 and "
        f"make_mesh() is one shard, so no copy crosses devices (the bytes are what the shards "
        f"would exchange)")
    return out


def grid_stream(k):
    """Sequence k of phase 21c's grid: the main stage's world and width on a
    line at the step of tests/test_eval_distributed.py's grid."""
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.io.synthetic import SyntheticDataset, SyntheticWorld

    world = SyntheticWorld(n_points=16000, extent=60.0, depth_range=(4.0, 80.0))
    return SyntheticDataset(num_frames=EVAL_GRID_FRAMES, h=H, w=W, fx=FX, baseline=BASELINE_M,
                            trajectory="line", step=0.3 + 0.02 * k,
                            sensor_type=SensorType.STEREO, world=world)


def eval_grid_phase(dev, cam):
    """21c: the evaluation grid over KITTI sequences written to disk, on
    [card] and [card, card], against each cell's serial deterministic run on
    the card, all under torch's deterministic algorithms."""
    import tempfile

    import torch

    from pyslam_tpu_torch.evaluation import manager
    from pyslam_tpu_torch.evaluation.manager import EvalConfig, SlamEvaluationManager
    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
    from pyslam_tpu_torch.ops.fast import fast_nms

    n = EVAL_GRID_FRAMES
    t0 = time.perf_counter()
    # in this process: for 20 frames, faster than starting worker processes
    frames = [(ds.getImage(i), ds.getImageRight(i), ds.getTimestamp(i))
              for ds in map(grid_stream, range(EVAL_GRID_SEQS)) for i in range(n)]
    out = {"frames": n * EVAL_GRID_SEQS, "render_s": time.perf_counter() - t0, "grids": {}}
    failed = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as root:
        datasets = []
        for k in range(EVAL_GRID_SEQS):
            name = f"{k:02d}"
            seq_root = os.path.join(root, name)
            write_kitti_sequence(seq_root, frames[k * n:(k + 1) * n], grid_stream(k))
            os.rename(os.path.join(seq_root, "sequences", "00"),
                      os.path.join(seq_root, "sequences", name))
            datasets.append({"type": "kitti", "base_path": seq_root, "name": name,
                             "sensor_type": "stereo", "camera": cam.to_json(),
                             "groundtruth": {"type": "kitti",
                                             "path": os.path.join(seq_root, "poses", "00.txt"),
                                             "times_path": os.path.join(
                                                 seq_root, "sequences", name, "times.txt")}})
        cfg = EvalConfig(datasets=datasets,
                         presets={"orb2": FeatureTrackerConfig(num_features=N_FEATURES,
                                                               num_levels=N_LEVELS)},
                         runs_per_dataset=1, loop_detector=None)
        torch.use_deterministic_algorithms(True, warn_only=True)
        # how far each serial cell places frame 1 from frame 0: it is tracked
        # without a motion model, and where its pose LM stalls the cell's
        # whole line follows (tests/torch_eval_grid_witness.py)
        first_step = []

        class FirstStepSlam(manager.Slam):
            def track(self, *a, frame_id=0, **kw):
                res = super().track(*a, frame_id=frame_id, **kw)
                if frame_id == 1:
                    first_step.append(float(np.linalg.norm(
                        np.linalg.inv(self.tracking.f_prev.Tcw)[:3, 3])))
                return res

        try:
            mgr = SlamEvaluationManager(cfg, out_dir=os.path.join(root, "serial"), device=dev)
            t0 = time.perf_counter()
            slam_cls, manager.Slam = manager.Slam, FirstStepSlam
            try:
                serial = {ds["name"]: mgr._single_run(ds, "orb2", cfg.presets["orb2"], 0,
                                                      deterministic=True) for ds in datasets}
            finally:
                manager.Slam = slam_cls
            out["serial_s"] = time.perf_counter() - t0
            out["frame1_m"] = first_step
            log("[eval-grid] serial runs: frame 1 placed " + ", ".join(
                f"{d:.4f} m" for d in first_step) + " from frame 0 (ground truth "
                + ", ".join(f"{0.3 + 0.02 * k:.2f} m" for k in range(EVAL_GRID_SEQS)) + ")")
            for tag, devices in (("one thread", [dev]), ("two threads", [dev, dev])):
                mgr = SlamEvaluationManager(cfg, out_dir=os.path.join(root, tag), device=dev)
                torch.cuda.synchronize()
                fast_nms.launches = 0
                t0 = time.perf_counter()
                mgr.run_distributed(devices=devices)
                torch.cuda.synchronize()
                row = {"wall_s": time.perf_counter() - t0, "launches": fast_nms.launches,
                       "reports": os.path.exists(os.path.join(root, tag, "table_rmse.csv")),
                       "cells": {}}
                for r in mgr.results:
                    a = serial[r.dataset]
                    row["cells"][r.dataset] = {
                        "ate": r.ate_rmse, "serial_ate": a.ate_rmse,
                        "keyframes": r.num_keyframes, "serial_keyframes": a.num_keyframes,
                        "points": r.num_points, "serial_points": a.num_points,
                        "percent_lost": r.percent_lost, "serial_percent_lost": a.percent_lost,
                        "bit_identical": (r.ate_rmse, r.num_keyframes, r.num_points,
                                          r.percent_lost) == (a.ate_rmse, a.num_keyframes,
                                                              a.num_points, a.percent_lost)}
                    if not (r.percent_lost == a.percent_lost
                            and abs(r.num_keyframes - a.num_keyframes) <= EVAL_KF_TOL
                            and abs(r.ate_rmse - a.ate_rmse) <= EVAL_ATE_TOL):
                        failed.append((tag, r.dataset))
                if row["launches"] != out["frames"] or not row["reports"]:
                    failed.append((tag, "launches", row["launches"], "reports", row["reports"]))
                out["grids"][tag] = row
                log(f"[eval-grid] run_distributed on {[str(d) for d in devices]} ({tag}): "
                    f"{row['wall_s']:.1f} s, fast_nms launches {row['launches']} for "
                    f"{out['frames']} frames; " + "; ".join(
                        f"sequence {name}: ATE {c['ate']:.4f} m (serial {c['serial_ate']:.4f}), "
                        f"{c['keyframes']} keyframes (serial {c['serial_keyframes']}), "
                        f"{c['points']} points (serial {c['serial_points']}), "
                        f"{100 - c['percent_lost']:.1f}% tracked (serial "
                        f"{100 - c['serial_percent_lost']:.1f}%), "
                        f"{'bit-identical' if c['bit_identical'] else 'not bit-identical'}"
                        for name, c in row["cells"].items()) + f"; reports {row['reports']}")
        finally:
            torch.use_deterministic_algorithms(False)
    log(f"[eval-grid] {EVAL_GRID_SEQS} KITTI sequences of {n} frames at {H}x{W} (rendered in "
        f"{out['render_s']:.1f} s), torch's deterministic algorithms on; the serial "
        f"deterministic runs took {out['serial_s']:.1f} s")
    out["failed"] = failed
    return out


def frontend_step_phase(dev, frames, ds):
    """21d: frontend_step at __graft_entry__.py's shape card against CPU,
    then a real frame against a map of the previous frame's stereo points."""
    import torch

    from pyslam_tpu_torch.features.orb2 import ORB2Extractor
    from pyslam_tpu_torch.ops.fast import fast_nms
    from pyslam_tpu_torch.pipeline import frontend_step

    rng = np.random.default_rng(0)
    M = FRONTEND_MAP_POINTS
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    pos = np.concatenate([rng.uniform(-10, 10, (M, 2)), rng.uniform(5, 40, (M, 1))],
                         axis=1).astype(np.float32)
    desc = rng.integers(0, 2, (M, 256)).astype(np.int8)
    K = np.asarray([[718.856, 0, 607.19], [0, 718.856, 185.2], [0, 0, 1]], np.float32)
    args = (img, pos, desc, np.ones(M, bool), np.eye(4, dtype=np.float32), K)
    fast_nms.launches = 0
    card = frontend_step(*args, device=dev)
    torch.cuda.synchronize()
    graft_launches = fast_nms.launches
    cpu = frontend_step(*args, device="cpu")
    same_kp = bool(torch.equal(card[0].xy.cpu(), cpu[0].xy)
                   and torch.equal(card[0].level.cpu(), cpu[0].level)
                   and torch.equal(card[0].desc.cpu(), cpu[0].desc))
    same_match = bool(torch.equal(card[1].cpu(), cpu[1]))
    tcw_err = float((card[2].cpu() - cpu[2]).abs().max())
    out = {"graft": {"keypoints_identical": same_kp, "matches_identical": same_match,
                     "matches": int((card[1] >= 0).sum()), "tcw_err": tcw_err,
                     "inliers": [int(card[3]), int(cpu[3])], "launches": graft_launches}}
    log(f"[frontend] __graft_entry__'s draw (376x1241, M {M}, seed 0) card against CPU: "
        f"keypoints and bits {'identical' if same_kp else 'DIFFER'}, matches "
        f"{'identical' if same_match else 'DIFFER'} ({out['graft']['matches']}), Tcw_opt within "
        f"{tcw_err:.3g}, inliers {int(card[3])} / {int(cpu[3])}, {graft_launches} fast_nms launch")

    # the real case: frame 0's stereo keypoints at the ground-truth pose
    left0, right0, _ = frames[0]
    bf = FX * BASELINE_M
    f0, _, depth0 = ORB2Extractor(N_FEATURES, N_LEVELS, device=dev).extract_stereo(
        left0, right0, bf=bf, max_disp=bf / 0.1, max_distance=100.0, row_tol=2.0)
    ok = (f0.valid & (depth0 > 0)).cpu().numpy()
    xy, z = f0.xy.cpu().numpy()[ok], depth0.cpu().numpy()[ok].astype(np.float64)
    pc = np.stack([(xy[:, 0] - ds.cx) / ds.fx * z, (xy[:, 1] - ds.cy) / ds.fy * z, z], 1)
    Twc0, Twc1 = ds.poses[0], ds.poses[1]
    map_pos = (pc @ Twc0[:3, :3].T + Twc0[:3, 3]).astype(np.float32)
    map_desc = f0.desc.cpu().numpy()[ok]
    Kr = np.asarray([[ds.fx, 0, ds.cx], [0, ds.fy, ds.cy], [0, 0, 1]], np.float32)
    Tcw0, Tcw1 = np.linalg.inv(Twc0), np.linalg.inv(Twc1)
    velocity = Tcw1 @ np.linalg.inv(Tcw0)   # the line's, the same every frame
    pred = velocity @ Tcw0
    pred[:3, 3] += [0.1, 0.0, 0.0]
    real = (frames[1][0], map_pos, map_desc, np.ones(len(map_pos), bool),
            pred.astype(np.float32), Kr)
    frontend_step(*real, device=dev)   # warm
    torch.cuda.synchronize()
    fast_nms.launches = 0
    times = []
    for _ in range(FRONTEND_CALLS):
        t0 = time.perf_counter()
        res = frontend_step(*real, device=dev)
        n_inl = int(res[3])
        times.append((time.perf_counter() - t0) * 1e3)
    launches = fast_nms.launches
    res_cpu = frontend_step(*real, device="cpu")
    real_kp = bool(torch.equal(res[0].xy.cpu(), res_cpu[0].xy)
                   and torch.equal(res[0].level.cpu(), res_cpu[0].level)
                   and torch.equal(res[0].desc.cpu(), res_cpu[0].desc))
    real_match = bool(torch.equal(res[1].cpu(), res_cpu[1]))
    real_tcw_err = float((res[2].cpu() - res_cpu[2]).abs().max())
    log(f"[frontend] the real frame card against CPU: keypoints and bits "
        f"{'identical' if real_kp else 'DIFFER'}, matches "
        f"{'identical' if real_match else 'DIFFER'}, Tcw_opt within {real_tcw_err:.3g}, "
        f"inliers {int(res[3])} / {int(res_cpu[3])}")
    Twc_opt = np.linalg.inv(res[2].cpu().numpy().astype(np.float64))
    err = float(np.linalg.norm(Twc_opt[:3, 3] - Twc1[:3, 3]))
    pred_err = float(np.linalg.norm(np.linalg.inv(pred)[:3, 3] - Twc1[:3, 3]))
    out["real"] = {"map_points": int(len(map_pos)), "matches": int((res[1] >= 0).sum()),
                   "inliers": n_inl, "pose_err_m": err, "prediction_err_m": pred_err,
                   "ms": statistics.median(times), "calls": FRONTEND_CALLS,
                   "launches": launches, "keypoints_identical": real_kp,
                   "matches_identical": real_match, "tcw_err": real_tcw_err}
    log(f"[frontend] frame 1 against frame 0's {len(map_pos)} stereo points: "
        f"{out['real']['matches']} matches, {n_inl} inliers, camera centre {err:.4f} m from the "
        f"ground truth (prediction {pred_err:.4f} m off); {out['real']['ms']:.1f} ms a call "
        f"(median of {FRONTEND_CALLS}, host clock with the result read), fast_nms launches "
        f"{launches} for {FRONTEND_CALLS} calls")
    failed = []
    if not (same_kp and same_match and graft_launches == 1):
        failed.append("graft draw card against CPU")
    if not (real_kp and real_match and real_tcw_err <= FRONTEND_TCW_TOL):
        failed.append("real case card against CPU")
    if not (n_inl >= FRONTEND_MIN_INLIERS and err <= FRONTEND_POSE_TOL_M
            and launches == FRONTEND_CALLS):
        failed.append("real case")
    out["failed"] = failed
    return out


def distributed_phase(dev, state, frames, ds, eval_grid=None):
    """Phase 21; returns its numbers, having checked every part of it; 21c's
    taken from ``eval_grid``, the second process's, where it is given."""
    from pyslam_tpu_torch.config_parameters import Parameters
    from pyslam_tpu_torch.slam.camera import PinholeCamera

    saved = Parameters.as_dict()
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                        bf=ds.fx * ds.baseline, depth_threshold=35.0)
    t = {}
    t0 = time.perf_counter()
    out = {"native": native_phase(dev, state, cam)}
    t["21a"] = time.perf_counter() - t0
    out["sharded_gba"] = sharded_gba_phase(dev, state, cam)
    t["21b"] = time.perf_counter() - t0 - sum(t.values())
    out["eval_grid"] = eval_grid if eval_grid else eval_grid_phase(dev, cam)
    Parameters.set_from_dict(saved)
    t["21c"] = time.perf_counter() - t0 - sum(t.values())
    out["frontend_step"] = frontend_step_phase(dev, frames, ds)
    t["21d"] = time.perf_counter() - t0 - sum(t.values())
    out["seconds"] = t
    log("[time] phase 21: " + json.dumps({k: round(v, 1) for k, v in t.items()}))
    failed = []
    if not out["native"]["in_sync"]:
        failed.append("21a: the mirror is not in sync with the dicts")
    gba = out["sharded_gba"]
    for name, row in gba["float64"].items():
        if not (np.isfinite(row["cost"]) and row["pose_err"] <= SHARD_POSE_TOL
                and row["point_err"] <= SHARD_POINT_TOL):
            failed.append(f"21b: float64 {name} outside the reference's tolerances")
    ref_cost = gba["variants"]["unsharded"]["cost"]
    for name, row in gba["variants"].items():
        if not (np.isfinite(row["cost"])
                and abs(row["cost"] - ref_cost) <= SHARD_COST_TOL * abs(ref_cost)):
            failed.append(f"21b: {name}'s final cost off the unsharded solve's")
    failed += [f"21c: {f}" for f in out["eval_grid"]["failed"]]
    failed += [f"21d: {f}" for f in out["frontend_step"]["failed"]]
    assert not failed, failed
    return out


def side_work(dev, frames):
    """The parts of phases 16-21 that need nothing of the first process but
    phase 7's first SIDE_FRAMES stereo ``frames``: (key, call) in their
    order in the phases."""
    from pyslam_tpu_torch.slam.camera import PinholeCamera

    ds = bench_stream()
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                        bf=ds.fx * ds.baseline, depth_threshold=35.0)
    return [("loftr", lambda: loftr_phase(dev, frames)), ("vpr", lambda: vpr_phase(dev, frames)),
            ("depth_models", lambda: depth_models_phase(dev, frames)),
            ("semantic_models", lambda: semantic_models_phase(dev, frames)),
            ("recon_models", lambda: recon_models_phase(dev, scene_views())),
            ("scene", lambda: scene_phase(dev)), ("gs_heldout", lambda: gs_heldout(dev)),
            ("gs_drift", lambda: gs_drift(dev)), ("dense_entry", lambda: dense_entry_phase(dev)),
            ("train", lambda: trainer_phase(dev)), ("eval_grid", lambda: eval_grid_phase(dev, cam))]


def side_main(out_dir, t_start):
    """The second process (``--side DIR T_START``): side_work on the card
    with SIDE_THREADS CPU threads at niceness SIDE_NICE, on the frames in
    DIR/frames.npz, its numbers written to DIR/side.json once every part
    has passed."""
    global T_START
    T_START = t_start
    import torch

    os.nice(SIDE_NICE)
    torch.set_num_threads(SIDE_THREADS)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port runs on the GPU only")
    import pyslam_tpu_torch  # noqa: F401  (precision policy)
    from pyslam_tpu_torch import _build

    _build.load()
    dev = torch.device("cuda", 0)
    with np.load(os.path.join(out_dir, "frames.npz")) as z:
        frames = [(z["left"][i], z["right"][i], z["ts"][i].item()) for i in range(len(z["ts"]))]
    numbers, seconds = {}, {}
    for key, run in side_work(dev, frames):
        t0 = time.perf_counter()
        numbers[key] = run()
        seconds[key] = round(time.perf_counter() - t0, 1)
    numbers["seconds"] = seconds
    path = os.path.join(out_dir, "side.json")
    with open(path + ".part", "w") as f:
        json.dump(numbers, f, default=_json_value)
    os.replace(path + ".part", path)


def main():
    import torch

    # ---------------------------------------------------------------- 1
    PHASE_START.append((1, time.perf_counter()))
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port runs on the GPU only")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {smi}")

    import pyslam_tpu_torch  # noqa: F401  (precision policy)
    from pyslam_tpu_torch import _build
    from pyslam_tpu_torch.evaluation.metrics import eval_ate
    from pyslam_tpu_torch.features.orb2 import ORB2Extractor
    from pyslam_tpu_torch.features.tracker import FeatureTrackerConfig
    from pyslam_tpu_torch.io.dataset_types import SensorType
    from pyslam_tpu_torch.ops import image as image_ops
    from pyslam_tpu_torch.ops.fast import fast_nms, fast_nms_plain, fast_nms_pyramid
    from pyslam_tpu_torch.ops.voxel_hash import INSERT_ROUNDS
    from pyslam_tpu_torch.slam.camera import PinholeCamera
    from pyslam_tpu_torch.slam.slam import Slam

    # ---------------------------------------------------------------- 2
    PHASE_START.append((2, time.perf_counter()))
    t0 = time.perf_counter()
    lib = _build.load()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 0.0:.2f} s)")
    for line in _build.ptxas_log.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    # ---------------------------------------------------------------- 3
    PHASE_START.append((3, time.perf_counter()))
    ds = bench_stream()
    left0, right0 = ds.getImage(0), ds.getImageRight(0)
    pair = torch.as_tensor(np.stack([left0, right0])).to(dev)
    levels = [lvl.contiguous() for lvl in image_ops.build_pyramid(pair, N_LEVELS, 1.2)]
    names = [f"level{lv} 2x{x.shape[1]}x{x.shape[2]}" for lv, x in enumerate(levels)]
    plain = [fast_nms_plain(x, FAST_TH) for x in levels]
    before = fast_nms.launches
    got = fast_nms_pyramid(levels, FAST_TH)
    torch.cuda.synchronize()
    assert fast_nms.launches == before + 1, "the pyramid call is not one launch"
    max_err = 0.0
    per_level_out = [torch.empty_like(x) for x in levels]

    def per_level(lv):
        x, o = levels[lv], per_level_out[lv]
        err = lib.pyslam_fast_nms_per_level(
            x.data_ptr(), o.data_ptr(), x.shape[0], x.shape[1], x.shape[2], FAST_TH, BORDER,
            torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"per-level kernel launch failed: cudaError {err}"

    for lv, name in enumerate(names):
        one = fast_nms(levels[lv], FAST_TH)
        per_level(lv)
        torch.cuda.synchronize()
        assert int((plain[lv] > 0).sum()) > 0, f"no corners at {name}"
        for what, x in (("pyramid call", got[lv]), ("one-level call", one),
                        ("per-level kernel", per_level_out[lv])):
            assert torch.equal(x, plain[lv]), f"{what} differs from the plain version at {name}"
            max_err = max(max_err, float((x - plain[lv]).abs().max()))
    rng = np.random.default_rng(0)
    ties = np.floor(rng.uniform(0, 8, (120, 160))).astype(np.float32) * 32.0
    for name, img in (("synth 1x150x200", synth_image(rng, 150, 200)),
                      ("band 1x113x160", band_image(rng)), ("ties 1x120x160", ties)):
        x = torch.as_tensor(img)[None].to(dev)
        ref = fast_nms_plain(x, FAST_TH)
        assert int((ref > 0).sum()) > 0, f"no corners at {name}"
        assert torch.equal(fast_nms(x, FAST_TH), ref), f"fast_nms differs at {name}"
        assert torch.equal(fast_nms_pyramid([x], FAST_TH)[0], ref), f"pyramid differs at {name}"
    log(f"[kernel] fast_nms: the one-launch pyramid call, the one-level call and the "
        f"per-level kernel equal the plain version at {len(names)} levels and 3 small images")

    work = fast_work(levels, FAST_TH, BORDER)
    new_frame = lambda: fast_nms_pyramid(levels, FAST_TH)  # noqa: E731
    old_frame = lambda: [per_level(lv) for lv in range(len(levels))]  # noqa: E731
    t_old1 = graph_ms(old_frame)
    t_new1 = graph_ms(new_frame)
    t_new2 = graph_ms(new_frame)
    t_old2 = graph_ms(old_frame)
    kern_ms = statistics.median([t_new1, t_new2])
    before_ms = statistics.median([t_old1, t_old2])
    eager_ms = median_ms(new_frame)
    plain_ms = median_ms(lambda: [fast_nms_plain(x, FAST_TH) for x in levels], n=10)
    for lv, name in enumerate(names):
        w_lv = fast_work([levels[lv]], FAST_TH, BORDER)
        log(f"[kernel] {name}: one-level call {graph_ms(lambda: fast_nms(levels[lv], FAST_TH)):.4f}"
            f" ms, per-level kernel {graph_ms(lambda: per_level(lv)):.4f} ms, bound "
            f"{w_lv['bound_ms']:.4f} ms ({w_lv['bound_by']}), pretest passes "
            f"{w_lv['pass_share'] * 100:.2f}% of the interior")
    log(f"[kernel] fast_nms, 8 levels of a stereo pair, per frame (CUDA-graph replays of "
        f"{GRAPH_LAUNCHES} launches, new/old in turns {t_old1:.4f} {t_new1:.4f} {t_new2:.4f} "
        f"{t_old2:.4f}): one launch {kern_ms:.4f} ms, the per-level kernel (8 launches) "
        f"{before_ms:.4f} ms, one eager call {eager_ms:.4f} ms, plain {plain_ms:.4f} ms; "
        f"bound {work['bound_ms']:.4f} ms ({work['bound_by']}: {work['bytes']} B, "
        f"{work['ops']} operations; pretest passes {work['pass_share'] * 100:.2f}% of the "
        f"interior), {work['bound_ms'] / kern_ms * 100:.1f}% of it")

    # ---------------------------------------------------------------- 4
    PHASE_START.append((4, time.perf_counter()))
    n_checks = check_ties(dev)
    log(f"[ties] argmin/argmax keep the first index and the stable sort keeps input order "
        f"on the card: {n_checks} checks")

    # ---------------------------------------------------------------- 5
    PHASE_START.append((5, time.perf_counter()))
    bf = FX * BASELINE_M
    args = dict(bf=bf, max_disp=bf / 0.1, max_distance=100.0, row_tol=2.0)
    fg, urg, _ = ORB2Extractor(N_FEATURES, N_LEVELS, device=dev).extract_stereo(
        left0, right0, **args)
    fc, urc, _ = ORB2Extractor(N_FEATURES, N_LEVELS, device="cpu").extract_stereo(
        left0, right0, **args)
    xyg, xyc = fg.xy.cpu().numpy(), fc.xy.numpy()
    same = np.all(xyg == xyc, 1) & (fg.level.cpu().numpy() == fc.level.numpy())
    shared = same & fg.valid.cpu().numpy() & fc.valid.numpy()
    desc_eq = bool(np.array_equal(fg.desc.cpu().numpy()[shared], fc.desc.numpy()[shared]))
    n_match = int((urg >= 0).sum())
    log(f"[frame] card vs CPU: {same.mean() * 100:.2f}% identical keypoints, descriptor "
        f"bits {'identical' if desc_eq else 'DIFFER'} on {int(shared.sum())} shared, "
        f"{n_match} stereo matches on the card ({int((urc >= 0).sum())} on the CPU)")
    assert same.mean() >= 0.99 and desc_eq and n_match > 0

    # ---------------------------------------------------------------- 6
    PHASE_START.append((6, time.perf_counter()))
    cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                        bf=ds.fx * ds.baseline, depth_threshold=35.0)
    dense_phase(dev, ds, cam, left0, right0)

    # ---------------------------------------------------------------- 7
    PHASE_START.append((7, time.perf_counter()))
    t0 = time.perf_counter()
    main_rgbd, loop_frames = render_all((render_main_rgbd_frames, N_FRAMES),
                                        (render_loop_frames, LOOP_FRAMES))
    frames = [(left, right, ts) for left, right, ts, _ in main_rgbd]
    rgbd_frames = [(left, depth, ts) for left, _, ts, depth in main_rgbd]
    del main_rgbd
    log(f"[main] rendered {N_FRAMES} stereo frames {H}x{W} with the left images' depth and "
        f"the loop stage's {LOOP_FRAMES} in {time.perf_counter() - t0:.1f} s (one pool of "
        f"worker processes)")
    slam = Slam(cam, FeatureTrackerConfig(num_features=N_FEATURES, num_levels=N_LEVELS),
                sensor_type=SensorType.STEREO, device=dev)
    integ = build_integrator(cam, dev)
    slam.set_volumetric_integrator(integ)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fast_nms.launches = 0
    lats = []
    t_start = None
    for i, (img_l, img_r, ts) in enumerate(frames):
        if i == 10:
            t_start = time.perf_counter()
        nxt = None
        if i + 1 < N_FRAMES:
            nl, nr, nts = frames[i + 1]
            nxt = {"img": nl, "img_right": nr, "frame_id": i + 1, "timestamp": nts}
        t1 = time.perf_counter()
        slam.track(img_l, img_right=img_r, frame_id=i, timestamp=ts, next_input=nxt)
        lats.append(time.perf_counter() - t1)
        if i % 10 == 0:
            log(f"[main] frame {i}: {lats[-1] * 1e3:.1f} ms, "
                f"{slam.map.num_keyframes()} keyframes, {slam.map.num_points()} points, "
                f"{integ.volume.num_voxels()} voxels")
    slam.finish()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = fast_nms.launches
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    n_tracked = len(slam.tracking.history.timestamps)
    ts_est, poses = slam.get_final_trajectory()
    gt_t = np.asarray([ds.getTimestamp(i) for i in range(N_FRAMES)])
    ate = eval_ate(ts_est, poses[:, :3, 3], gt_t, ds.poses[:, :3, 3], align=True,
                   with_scale=False).rmse
    lat_ms = np.asarray(lats[10:]) * 1e3
    n_kfs = slam.map.num_keyframes()
    n_lba = slam.local_mapping.lba_applied
    n_vox = integ.volume.num_voxels()
    load = n_vox / integ.volume.capacity
    n_snap = len(integ.snapshots)
    log(f"[main] {(N_FRAMES - 10) / wall:.2f} FPS over frames 10-{N_FRAMES - 1} (incl. final "
        f"drain), latency p50 {np.percentile(lat_ms, 50):.1f} ms p95 "
        f"{np.percentile(lat_ms, 95):.1f} ms; {n_tracked}/{N_FRAMES} tracked, {n_kfs} "
        f"keyframes, {slam.map.num_points()} points, {n_lba} local BAs applied, "
        f"ATE {ate:.4f} m; fast_nms launches {launches}")
    dropped, valid = keyframe_drops(integ.volume, integ._depth_provider, cam, frames[-1][0],
                                    frames[-1][1], ds.poses[N_FRAMES - 1])
    drop = dropped / max(valid, 1)
    voxels_per_frame = frame_voxels(integ.volume, integ._depth_provider, cam, frames,
                                    ds.poses[:N_FRAMES])
    table_ok = check_table(integ.volume.table, integ.volume.num_integrated, voxels_per_frame,
                           drop)
    log(f"[main] dense: {n_snap} keyframes handed over, {integ.volume.num_integrated} "
        f"integrated, {n_vox} voxels, load factor {load:.4f} (ceiling "
        f"{table_ok['load_ceiling']:.4f} for {integ.volume.num_integrated} keyframes; the "
        f"capacity flag's sizing rule is <= 0.25: {'kept' if load <= 0.25 else 'exceeded'}); "
        f"probe sequences: {table_ok['beyond']} keys beyond the claim rounds, "
        f"{table_ok['holes']} holes, {table_ok['duplicates']} duplicates, "
        f"{table_ok['aliases']} fingerprint aliases, displacement <= "
        f"{table_ok['max_displacement']}; a keyframe of the last frame would leave {dropped} of "
        f"its {valid} valid updates ({drop * 100:.3f}%, ceiling {DROP_MAX * 100:.0f}%) "
        f"unresolved after the {INSERT_ROUNDS} claim rounds (dropped); peak device memory "
        f"{peak_mb:.1f} MiB (torch.cuda.max_memory_allocated)")
    log("[main] stage totals: " + json.dumps(
        {mod: {k: round(v["total_ms"], 1) for k, v in st.items()}
         for mod, st in slam.timings().items()}))
    assert launches == N_FRAMES, f"{launches} fast_nms launches for {N_FRAMES} frames"
    assert n_kfs >= 2 and n_lba >= 1, (n_kfs, n_lba)
    assert n_tracked == N_FRAMES, f"{n_tracked}/{N_FRAMES} tracked"
    assert np.isfinite(poses).all() and ate < ATE_MAX, ate
    assert n_snap >= 1 and integ.volume.num_integrated == n_snap, \
        (n_snap, integ.volume.num_integrated)
    assert n_vox > 0, n_vox
    assert integ.volume.table.tsdf.device.type == "cuda"
    del slam, integ
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 8
    PHASE_START.append((8, time.perf_counter()))
    cam_args = (ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy)
    loop_launches = loop_phase(dev, cam_args, loop_frames)["launches"]
    torch.cuda.empty_cache()   # the frames stay for phase 14c
    side = SideProcess(frames[:SIDE_FRAMES])
    log("[side] the second process started: 16a, 16c, 17a, 18a, 19a-c, 19d's held-out and "
        "drift witnesses, 19e, 20a and 21c")

    # ---------------------------------------------------------------- 9
    PHASE_START.append((9, time.perf_counter()))
    from pyslam_tpu_torch.config_parameters import Parameters
    from pyslam_tpu_torch.dense.volumetric_integrator import (
        VolumetricIntegratorType, volumetric_integrator_factory)

    ds_rgbd = bench_stream("RGBD")
    cam_rgbd = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                             bf=ds.fx * BASELINE_M, depth_threshold=35.0)
    # the TSDF integrator on the sensor's depth: no estimator, the main
    # stage's voxel, truncation and table
    Parameters.kVolumetricIntegrationUseDepthEstimator = False
    Parameters.kVolumetricIntegrationDepthTruncOutdoor = DEPTH_TRUNC_OUTDOOR
    integ = volumetric_integrator_factory(
        VolumetricIntegratorType.TSDF, camera=cam_rgbd,
        environment_type=type("E", (), {"name": "OUTDOOR"})(),
        voxel_size=VOXEL_SIZE, sdf_trunc=SDF_TRUNC, device=dev)
    assert integ._depth_provider is None and integ.volume.capacity == TABLE_CAPACITY
    rgbd, slam, _ = sensor_stage(dev, "RGBD", rgbd_frames[:RGBD_FRAMES], cam_rgbd, ds_rgbd,
                                 integ)
    assert rgbd["launches"] == RGBD_FRAMES, f"{rgbd['launches']} fast_nms launches"
    assert rgbd["n_tracked"] == RGBD_FRAMES, f"{rgbd['n_tracked']}/{RGBD_FRAMES} tracked"
    assert rgbd["ate"] < ATE_MAX, rgbd["ate"]
    assert rgbd["snapshots"] >= 1 and rgbd["integrated"] == rgbd["snapshots"], rgbd
    assert rgbd["voxels"] > 0 and integ.volume.table.tsdf.device.type == "cuda"
    del slam, integ
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 10
    PHASE_START.append((10, time.perf_counter()))
    ds_mono = bench_stream("MONOCULAR")
    cam_mono = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                             depth_threshold=35.0)
    mono_frames = [(img, None, ts) for img, _, ts in rgbd_frames]
    mono, slam, init_samples = sensor_stage(dev, "MONOCULAR", mono_frames, cam_mono, ds_mono)
    init_frame = mono["init_frame"]
    assert init_frame is not None and init_frame <= MONO_REF_INIT_FRAME + MONO_INIT_MARGIN, \
        f"initialised at frame {init_frame}, the reference at {MONO_REF_INIT_FRAME}"
    assert mono["n_tracked"] == N_FRAMES - init_frame, \
        f"{mono['n_tracked']} tracked from frame {init_frame} on"
    assert mono["launches"] == N_FRAMES, f"{mono['launches']} fast_nms launches"
    assert mono["ate"] < ATE_MAX, mono["ate"]
    del slam
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 11
    PHASE_START.append((11, time.perf_counter()))
    vo, tracker = vo_phase(dev, rgbd_frames, cam_mono, ds_rgbd)
    assert vo["mono"]["launches"] == N_FRAMES and vo["rgbd"]["launches"] == N_FRAMES, \
        {k: v["launches"] for k, v in vo.items()}
    assert vo["mono"]["ate"] < VO_MONO_ATE_MAX and vo["rgbd"]["ate"] < VO_RGBD_ATE_MAX, \
        {k: v["ate"] for k, v in vo.items()}
    card = card_vs_cpu(dev, rgbd_frames, cam_rgbd, tracker)
    init_cost = mono_init_cost(dev, mono_frames, cam_mono, tracker, mono["ref_frame"],
                               init_frame, init_samples)
    one = one_image_kernels(dev, rgbd_frames)
    log("[sensors] " + json.dumps({
        "rgbd": {k: v for k, v in rgbd.items()},
        "mono": {k: v for k, v in mono.items()},
        "vo": {k: {kk: vv for kk, vv in v.items() if kk != "vo"} for k, v in vo.items()},
        "card_vs_cpu": card, "mono_init_cost": init_cost, "kernel_calls": one},
        default=float))

    # ---------------------------------------------------------------- 12
    PHASE_START.append((12, time.perf_counter()))
    feats = features_phase(dev, frames[:PRESET_FRAMES], cam, ds)
    print(json.dumps({"features": feats}, default=float), flush=True)

    # ---------------------------------------------------------------- 13
    PHASE_START.append((13, time.perf_counter()))
    state_root = tempfile.mkdtemp(prefix="chip_smoke_state_")
    atexit.register(shutil.rmtree, state_root, True)
    saved_state = os.path.join(state_root, "state")
    entry = entry_phase(dev, frames, ds, keep_state=saved_state)
    print(json.dumps({"entry": entry}, default=float), flush=True)

    # ---------------------------------------------------------------- 14
    PHASE_START.append((14, time.perf_counter()))
    models = {"superpoint": superpoint_phase(dev, frames, cam, ds),
              "lightglue_vo": lightglue_vo_phase(dev, rgbd_frames, cam_mono, ds_rgbd)}
    retain = Parameters.kRetainImageForVPR
    try:
        cos = models["cosplace"] = loop_phase(dev, cam_args, loop_frames, loop="COSPLACE")
    finally:
        Parameters.kRetainImageForVPR = retain
    log(f"[cosplace] loop stage: {cos['n_tracked']}/{LOOP_FRAMES} tracked, "
        f"{cos['loops_closed']} loops closed, ATE {cos['ate']:.4f} m; the JAX package on the "
        f"CPU: {WITNESS_COSPLACE[0]}/{LOOP_FRAMES} tracked, {WITNESS_COSPLACE[1]} loops closed, "
        f"ATE {WITNESS_COSPLACE[2]} m")
    print(json.dumps({"models": models}, default=float), flush=True)

    # ---------------------------------------------------------------- 15
    PHASE_START.append((15, time.perf_counter()))
    learned = {"models": learned_models_phase(dev, frames),
               "sessions": learned_sessions_phase(dev, frames[:LEARNED_FRAMES], cam, ds),
               "xfeat_lightglue_vo": lightglue_vo_phase(
                   dev, rgbd_frames[:LEARNED_FRAMES], cam_mono, ds_rgbd,
                   preset="XFEAT_LIGHTGLUE")}
    print(json.dumps({"learned": learned}, default=float), flush=True)

    # ---------------------------------------------------------------- 16
    PHASE_START.append((16, time.perf_counter()))
    side_numbers = side.join()
    dense = {"loftr": side_numbers["loftr"], "mast3r": mast3r_phase(dev, frames, cam, ds),
             "vpr": side_numbers["vpr"]}
    vl = dense["vlad_stage"] = loop_phase(dev, cam_args, loop_frames, loop="VLAD")
    del loop_frames
    log(f"[vlad] loop stage: {vl['n_tracked']}/{LOOP_FRAMES} tracked, {vl['loops_closed']} "
        f"loops closed, ATE {vl['ate']:.4f} m, fast_nms launches {vl['launches']}; the JAX "
        f"package on the CPU: {WITNESS_VLAD[0]}/{LOOP_FRAMES} tracked, {WITNESS_VLAD[1]} loops "
        f"closed, ATE {WITNESS_VLAD[2]} m")
    assert vl["loops_closed"] >= VLAD_MIN_LOOPS, f"{vl['loops_closed']} loops closed"
    print(json.dumps({"dense": dense}, default=float), flush=True)

    # ---------------------------------------------------------------- 17
    PHASE_START.append((17, time.perf_counter()))
    depth = depth_phase(dev, frames, cam, ds, models=side_numbers["depth_models"])
    print(json.dumps({"depth": depth}, default=float), flush=True)

    # ---------------------------------------------------------------- 18
    PHASE_START.append((18, time.perf_counter()))
    semantic = semantic_phase(dev, frames, cam, ds, voxels_per_frame,
                              models=side_numbers["semantic_models"])
    print(json.dumps({"semantic": semantic}, default=float), flush=True)

    # ---------------------------------------------------------------- 19
    PHASE_START.append((19, time.perf_counter()))
    recon = reconstruction_phase(dev, rgbd_frames, cam_rgbd, ds_rgbd, side=side_numbers)
    print(json.dumps({"reconstruction": recon}, default=float), flush=True)

    # ---------------------------------------------------------------- 20
    PHASE_START.append((20, time.perf_counter()))
    trainers = {"train": side_numbers["train"]}
    trainers["large_ba"], lba_slam = large_ba_phase(dev, frames[:LARGE_BA_FRAMES], cam)
    trainers["bag"] = bag_phase(dev, frames[:BAG_FRAMES], cam)
    trainers["viewer"] = viewer_phase(lba_slam)
    del lba_slam
    trainers["wall_s"] = time.perf_counter() - T_START
    ends = [t for _, t in PHASE_START[1:]] + [time.perf_counter()]
    trainers["phase_s"] = {ph: round(end - t, 1) for (ph, t), end in zip(PHASE_START, ends)}
    log(f"[time] the script so far {trainers['wall_s']:.1f} s; seconds a phase "
        f"{json.dumps(trainers['phase_s'])}")
    print(json.dumps({"trainers": trainers}, default=float), flush=True)

    # ---------------------------------------------------------------- 21
    PHASE_START.append((21, time.perf_counter()))
    dist = distributed_phase(dev, saved_state, frames, ds, eval_grid=side_numbers["eval_grid"])
    dist["wall_s"] = time.perf_counter() - T_START
    ends = [t for _, t in PHASE_START[1:]] + [time.perf_counter()]
    dist["phase_s"] = {ph: round(end - t, 1) for (ph, t), end in zip(PHASE_START, ends)}
    log(f"[time] the script {dist['wall_s']:.1f} s; seconds a phase "
        f"{json.dumps(dist['phase_s'])}")
    print(json.dumps({"distributed": dist}, default=float), flush=True)

    print(json.dumps({"kernels": [{
        "name": "fast_nms", "route": "cuda",
        "source": "pyslam_tpu_torch/csrc/fast_nms.cu",
        "replaces": "pyslam_tpu/ops/pallas_fast.py:95",
        "launches": launches, "launches_per_frame": launches / N_FRAMES,
        "launches_loop_stage": loop_launches,
        "launches_rgbd_stage": rgbd["launches"], "launches_mono_stage": mono["launches"],
        "launches_vo_mono": vo["mono"]["launches"], "launches_vo_rgbd": vo["rgbd"]["launches"],
        "launches_beblid_stage": feats["ORB2_BEBLID"]["launches"],
        "launches_entry_stage": entry["launches"],
        "launches_superpoint_stage": models["superpoint"]["session"]["launches"],
        "launches_cosplace_stage": cos["launches"],
        "launches_orb2_hardnet_stage": learned["sessions"]["ORB2_HARDNET"]["launches"],
        "launches_vlad_stage": vl["launches"],
        "launches_depth_stage": depth["sgbm_upgrade"]["launches"],
        "launches_depth_anything_v2_stage":
            depth["learned_upgrade"]["depth_anything_v2"]["launches"],
        "launches_depth_mast3r_stage": depth["learned_upgrade"]["mast3r"]["launches"],
        "launches_semantic_stage": semantic["session"]["launches"],
        "launches_scene_from_views": recon["geometric"]["launches"],
        "launches_gs_stage": recon["gs"]["launches"],
        "launches_large_ba_stage": trainers["large_ba"]["launches"],
        "launches_bag_stage": trainers["bag"]["launches"],
        "launches_frontend_step": dist["frontend_step"]["real"]["launches"],
        "launches_eval_grid": dist["eval_grid"]["grids"]["two threads"]["launches"],
        "launches_sharded_gba_maps": entry["launches"],
        "mono_frame": one["b1_pyramid"], "vo_rgbd_level_th15": one["vo_level_th15"],
        "max_abs_err": max_err, "ms": kern_ms, "plain_ms": plain_ms,
        "bound_ms": work["bound_ms"], "bound_by": work["bound_by"], "library_ms": None,
        "before_ms": before_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--side"]:
        side_main(sys.argv[2], float(sys.argv[3]))
    else:
        main()
    sys.exit(0)
