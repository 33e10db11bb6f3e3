"""Global framework parameters (flag registry).

Analog of the reference's static ``Parameters`` class
(``pyslam/config_parameters.py:45+`` in luigifreda/pyslam): a single class of
``k*`` class attributes that every subsystem reads.

Copied from ``pyslam_tpu/config_parameters.py``, keeping only the flags this
package reads, with the same values. The flags of the subsystems not ported
yet come with the code that reads them;
the thread/process, viewer, GTSAM and debug-file flags have no counterpart
here.
"""

from __future__ import annotations


class Parameters:
    # ------------------------------------------------------------------ core
    kNumFeatures = 2000                     # padded keypoint capacity per frame
    kNumLevels = 8                          # image pyramid levels
    kScaleFactor = 1.2                      # pyramid scale factor
    kFASTThreshold = 20                     # FAST corner threshold (initial)

    # ------------------------------------------------------------ matching
    kMaxDescriptorDistance = 100            # ORB Hamming acceptance (ref feature_types.py:164)
    kMatchRatioTest = 0.75                  # Lowe ratio for generic matching
    kMatchRatioTestMap = 0.8                # ratio used when matching against map
    kCheckOrientation = True                # rotation-histogram consistency filter

    # ------------------------------------------------------------- tracking
    kUseMotionModel = True
    kMinNumMatchedFeaturesSearchFrameByProjection = 20
    kMaxReprojectionDistanceFrame = 7       # px radius, search prev frame by projection
    kMaxReprojectionDistanceFrameWide = 14  # widened radius on failure
    kMaxReprojectionDistanceMap = 3         # px radius, search map by projection
    kMinTrackedFeaturesForPoseOpt = 10
    kNumMinInliersPoseOptimizationTrackFrame = 10
    kNumMinInliersTrackLocalMap = 30
    kUseSearchFrameByProjection = True
    kMaxNumOfKeyframesInLocalMap = 80
    # cap on local-map points per tracking step; larger local maps are
    # subsampled by observation count (see tracking.track_local_map)
    kTrackLocalMapMaxPoints = 8192
    kMaxLostFramesBeforeReset = 5           # auto-reset if LOST early (ref tracking.py:1424)
    # per-frame wall-clock budget for back-end host slices (step_async):
    # bounds tracking latency while letting the back-end digest a keyframe
    # within ~a frame like the reference's mapping thread
    kLocalMappingHostBudgetMs = 8.0
    kLogKeyFrameDecision = False            # per-frame KF-condition debug log
    kUseDynamicDesDistanceTh = True         # adaptive descriptor threshold (MAD stats)
    kUseFusedTrackingStep = True            # one-dispatch OK-path tracking (ops/fused_tracking.py)

    # ---------------------------------------------------------- initializer
    kInitializerNumMinFeatures = 100        # ref :109
    kInitializerNumMinFeaturesStereo = 500  # ref :110
    kInitializerNumMinTriangulatedPoints = 150   # ref :111
    kInitializerNumMinTriangulatedPointsStereo = 100  # ref :112
    kInitializerFeatureMatchRatioTest = 0.9  # ref :113

    # ---------------------------------------------------------- keyframes
    kNumMinPointsForNewKf = 15              # min tracked points to allow a new KF
    kThNewKfRefRatio = 0.9                  # cond: tracked/ref-tracked ratio (mono)
    kThNewKfRefRatioStereo = 0.75           # stereo variant
    kThNewKfRefRatioNonMonocular = 0.25     # cond2b non-mono (ref :149)
    kNumMaxFramesBetweenKfs = 30            # cond1a: max frames since last KF (~fps)
    kNumMinFramesBetweenKfs = 0             # min frames between KFs
    kNumMinTrackedClosePointsForNewKfNonMonocular = 100  # ref :143
    kNumMaxNonTrackedClosePointsForNewKfNonMonocular = 70  # ref :144

    # ------------------------------------------------------- local mapping
    kLocalBAWindowSize = 20                 # covisibility window for LBA (ref :221)
    kKeyframeCullingRedundantObsRatio = 0.9 # cull KF if 90% points redundantly seen
    kKeyframeCullingMinNumPoints = 3
    kMapPointCullingMinFoundRatio = 0.25    # found/visible acceptance for new points
    kUseLargeWindowBA = False               # periodic large-window BA (ref :222)
    kEveryNumFramesLargeWindowBA = 10       # keyframes between large BAs (ref :225)
    kLargeBAWindowSize = 20
    kLocalMappingNumNeighborKeyFramesStereo = 10    # triangulation neighbors (ref :191)
    kLocalMappingNumNeighborKeyFramesMonocular = 20  # ref :194
    kMinNumOfCovisiblePointsForCreatingConnection = 15  # ref :200

    # ------------------------------------------------------------ optimizer
    # 6 LM iterations in two 3-iteration chunks: each keyframe's window is
    # warm-started from the last one (poses/points barely move between
    # consecutive LBAs).  (reference g2o runs 5+10, but from a COLD graph
    # each time, optimizer_g2o.py:824)
    kOptimizerLBAIterations = 6
    # LBA problem caps (cameras / points / observations): a larger window is
    # truncated to these (see local_mapping._lba_build)
    kLBAMaxCameras = 56          # >= window (20+1) + capped fixed set
    kLBAMaxPoints = 4096
    kLBAMaxObservations = 16384
    kOptimizerGBAIterations = 15
    kOptimizerPGOIterations = 30

    # --------------------------------------------------------- loop closing
    kUseLoopClosing = True
    kLoopClosingMinNumConsistentGroups = 3  # consistency threshold (ref loop_closing.py:107)
    kLoopClosingNumCovisiblesForCandidate = 10
    kLoopClosingMinNumMatchedMapPoints = 40 # geometry check acceptance (ref :257)
    kLoopClosingGeometryCheckerMinNumBoWMatches = 20
    kLoopClosingTh2 = 10.0
    kLoopDetectionMinFramesAfterLastDetection = 10
    kLoopDetectionMinKeyframeDistance = 10  # candidate must be >= N keyframes old (temporal gate)
    kRetainImageForVPR = False              # keep half-res frame copies for learned VPR (CosPlace-class)
    kSim3SolverRansacIterations = 300
    kSim3SolverMinInliers = 20
    kLoopClosingFeatureMatchRatioTest = 0.9  # ref :259
    # direct-index gating depth for loop guided matching: pairs must share a
    # vocabulary-tree ancestor ``depth - this`` levels down (reference DBoW
    # di_levels; larger value = coarser gate / more candidate pairs)
    kLoopClosingDirectIndexLevel = 3

    # -------------------------------------------------------- relocalization
    kRelocalizationMinPnPInliers = 15
    kRelocalizationFinalMinNumInliers = 50  # accept relocalization with >=50 inliers
    kRelocalizationPnPRansacIterations = 256
    kRelocalizationFeatureMatchRatioTest = 0.75  # ref :270
    kMaxReprojectionDistanceMapRelocalize = 5

    # -------------------------------------------------------------- stereo
    kStereoMatchingRowTolerance = 2.0       # rows tolerance for rectified match
    kStereoMatchingMaxDescriptorDistance = 100
    kMinDepth = 0.1

    # ----------------------------------------------------------- map points
    kScaleConsistencyFactor = 1.5
    kMaxOrbDistanceSearchByReproj = 50      # descriptor gate on projection search
    kCosMaxParallax = 0.9998                # triangulation parallax acceptance
    kMinRatioBaselineDepth = 0.01           # mono triangulation: baseline / median depth

    # -------------------------------------------------------------- dense
    kVolumetricIntegrationVoxelSize = 0.05
    kVolumetricIntegrationSdfTrunc = 0.2
    kVolumetricIntegrationDepthTruncIndoor = 4.0
    kVolumetricIntegrationDepthTruncOutdoor = 10.0
    # the reference's flag; neither the reference nor the port reads it yet
    kVolumetricIntegrationMinNumLBATimes = 1
    kVolumetricIntegrationUseDepthEstimator = False
    # estimator used when kVolumetricIntegrationUseDepthEstimator is on
    kVolumetricIntegrationDepthEstimatorType = "sgbm"
    # SGM internal resolution divisor for integration-time depth: 2 runs the
    # matcher at half resolution and half the disparity range (the same
    # metric depth range, since disparity scales with fx)
    kVolumetricIntegrationDepthSGMDownscale = 2
    # voxel-hash table slots: keep the load factor <= ~0.25 (the insert
    # probes at most INSERT_ROUNDS slots; a saturated table stops growing)
    kVolumetricIntegrationTableCapacity = 1 << 22
    # max voxel samples on each side of the measured surface per depth ray
    kVolumetricIntegrationBandMaxSteps = 2

    # ------------------------------------------------------------ semantics
    kUseSemanticsInOptimization = False     # semantic BA weighting (ref :402)

    # ------------------------------------------------------------- storage
    kMapPointCapacityInitial = 1 << 15      # initial SoA map-point capacity

    @classmethod
    def set_from_dict(cls, d: dict) -> None:
        """Override flags from a dict (the yaml GLOBAL_PARAMETERS hook); an
        unknown flag raises KeyError."""
        for k, v in d.items():
            if not hasattr(cls, k):
                raise KeyError(f"unknown Parameters flag: {k}")
            setattr(cls, k, v)

    @classmethod
    def as_dict(cls) -> dict:
        return {k: v for k, v in vars(cls).items() if k.startswith("k") and not callable(v)}
