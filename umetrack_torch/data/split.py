"""Dataset splits; the split is the leaf folder name."""
from enum import Enum


class Split(Enum):
    TRAIN = "training"
    TEST = "testing"
