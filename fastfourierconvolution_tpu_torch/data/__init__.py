"""Data layer: local-format dataset readers, transforms, batch loader."""

from .datasets import (  # noqa: F401
    ArrayDataset,
    AUG_STACKS,
    ConcatDataset,
    ImageFolderDataset,
    ShapesDataset,
    SyntheticDataset,
    TarImageDataset,
    TransformedDataset,
    is_grayscale,
    load_cifar10,
    apply_aug_stack,
    load_dataset,
    load_mnist,
    load_stl10,
    load_svhn,
)
from .loader import DataLoader, normalize_to_unit  # noqa: F401
