"""Loop detector configurations (host copy of
``pyslam_tpu/loop_closing/loop_detector_configs.py``: the enums,
``LoopDetectorConfig`` and the presets).  The port's ``LoopDetector``
runs every one of them (see ``loop_closing.LoopDetector``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class GlobalDescriptorType(enum.Enum):
    DBOW2 = "dbow2"          # BoW on binary vocabulary (compat name)
    DBOW3 = "dbow3"          # same engine, reference's default
    IBOW = "ibow"            # incremental BoW (online-trained vocabulary)
    OBINDEX2 = "obindex2"
    VLAD = "vlad"
    NETVLAD = "netvlad"      # learned (models.netvlad)
    HDC_DELF = "hdc_delf"
    SAD = "sad"
    ALEXNET = "alexnet"
    COSPLACE = "cosplace"
    EIGENPLACES = "eigenplaces"
    MEGALOC = "megaloc"


class LoopDetectorVocabularyType(enum.Enum):
    PROCEDURAL_4K = "procedural_4k"
    PROCEDURAL_16K = "procedural_16k"
    SESSION_TRAINED = "session_trained"
    # k-ary tree vocabularies (DBoW3 analog) with a direct index for guided
    # matching; HIERARCHICAL_SESSION self-seeds from session descriptors,
    # PRETRAINED loads a converted DBoW3 vocabulary (.npz via
    # tools/convert_checkpoint.py, path in extra["vocabulary_path"])
    HIERARCHICAL_SESSION = "hierarchical_session"
    PRETRAINED = "pretrained"


@dataclass
class LoopDetectorConfig:
    name: str = "DBOW3"
    global_descriptor_type: GlobalDescriptorType = GlobalDescriptorType.DBOW3
    vocabulary_type: LoopDetectorVocabularyType = LoopDetectorVocabularyType.PROCEDURAL_4K
    num_words: int = 4096
    extra: dict = field(default_factory=dict)

    def to_json(self):
        return {
            "name": self.name,
            "global_descriptor_type": self.global_descriptor_type.value,
            "vocabulary_type": self.vocabulary_type.value,
            "num_words": self.num_words,
        }

    @staticmethod
    def from_json(d):
        return LoopDetectorConfig(
            name=d.get("name", "DBOW3"),
            global_descriptor_type=GlobalDescriptorType(
                d.get("global_descriptor_type", "dbow3")
            ),
            vocabulary_type=LoopDetectorVocabularyType(
                d.get("vocabulary_type", "procedural_4k")
            ),
            num_words=d.get("num_words", 4096),
        )


class LoopDetectorConfigs:
    """Preset registry mirroring the reference's config names."""

    # DBoW presets run the hierarchical tree vocabulary (direct index +
    # guided matching), like the reference's DBoW2/DBoW3 engines; a
    # converted pretrained vocabulary upgrades them via
    # extra={"vocabulary_path": ...}
    DBOW2 = LoopDetectorConfig(
        name="DBOW2", global_descriptor_type=GlobalDescriptorType.DBOW2,
        vocabulary_type=LoopDetectorVocabularyType.HIERARCHICAL_SESSION,
    )
    DBOW3 = LoopDetectorConfig(
        name="DBOW3", global_descriptor_type=GlobalDescriptorType.DBOW3,
        vocabulary_type=LoopDetectorVocabularyType.HIERARCHICAL_SESSION,
    )
    DBOW3_INDEPENDENT = LoopDetectorConfig(
        name="DBOW3_INDEPENDENT",
        global_descriptor_type=GlobalDescriptorType.DBOW3,
        vocabulary_type=LoopDetectorVocabularyType.SESSION_TRAINED,
    )
    IBOW = LoopDetectorConfig(
        name="IBOW",
        global_descriptor_type=GlobalDescriptorType.IBOW,
        vocabulary_type=LoopDetectorVocabularyType.SESSION_TRAINED,
    )
    VLAD = LoopDetectorConfig(
        name="VLAD", global_descriptor_type=GlobalDescriptorType.VLAD, num_words=64
    )
    SAD = LoopDetectorConfig(
        name="SAD", global_descriptor_type=GlobalDescriptorType.SAD
    )
    NETVLAD = LoopDetectorConfig(
        name="NETVLAD", global_descriptor_type=GlobalDescriptorType.NETVLAD
    )
    COSPLACE = LoopDetectorConfig(
        name="COSPLACE", global_descriptor_type=GlobalDescriptorType.COSPLACE
    )
    EIGENPLACES = LoopDetectorConfig(
        name="EIGENPLACES",
        global_descriptor_type=GlobalDescriptorType.EIGENPLACES,
    )
    MEGALOC = LoopDetectorConfig(
        name="MEGALOC", global_descriptor_type=GlobalDescriptorType.MEGALOC
    )
    ALEXNET = LoopDetectorConfig(
        name="ALEXNET", global_descriptor_type=GlobalDescriptorType.ALEXNET
    )
    HDC_DELF = LoopDetectorConfig(
        name="HDC_DELF", global_descriptor_type=GlobalDescriptorType.HDC_DELF
    )

    @staticmethod
    def get(name: str) -> LoopDetectorConfig:
        cfg = getattr(LoopDetectorConfigs, name, None)
        if cfg is None:
            raise KeyError(f"unknown loop detector preset {name}")
        return cfg
