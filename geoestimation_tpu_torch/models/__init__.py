"""Models: ResNet backbones, the multi-partitioning classifier, the fast path."""

from .classifier import MultiHeadClassifier, MultiPartitioningClassifier
from .resnet import FEATURE_DIM, STAGE_SIZES, ResNet, build_backbone
