from . import bundles, dataset, fs, idxbin, split, transform
from .dataset import (
    ConcatDataset,
    FolderDataset,
    Sampler,
    find_dataset,
    find_torchdata_folders,
    iterate_dataset,
    prefetch_map,
)
from .idxbin import IdxBinFile, write_idxbin
from .split import Split
from .transform import ModelInput, ModelTarget, RawSequence, preprocess

__all__ = [
    "bundles",
    "dataset",
    "fs",
    "idxbin",
    "split",
    "transform",
    "ConcatDataset",
    "FolderDataset",
    "Sampler",
    "find_dataset",
    "find_torchdata_folders",
    "iterate_dataset",
    "prefetch_map",
    "IdxBinFile",
    "write_idxbin",
    "Split",
    "ModelInput",
    "ModelTarget",
    "RawSequence",
    "preprocess",
]
