"""Datasets, cube slicing and batching, q sampling, augmentations and
synthetic point clouds."""

from .dataset import StaticDataset, RawLoader, collate_cubes, slice_into_cubes
from .q_func import QFunc
from .transform import build_transforms, ColorJitter, RandomRotate
