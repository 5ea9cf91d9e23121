"""Models: ResNet backbones, the multi-partitioning and ISN classifiers, the
fast path."""

from .classifier import MultiHeadClassifier, MultiPartitioningClassifier
from .isn import ISNClassifier
from .resnet import FEATURE_DIM, STAGE_SIZES, ResNet, build_backbone
