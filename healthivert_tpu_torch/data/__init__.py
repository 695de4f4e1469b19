"""Host-side (numpy) slice sampling, the straightened dataset, synthetic
spine volumes, device prefetch, and the dataset registry of the command line
and the training loop (healthivert_tpu/data/__init__.py)."""

from __future__ import annotations

DATASETS = ("aligned", "synthetic")


def get_option_setter(name: str):
    """Both datasets inject no flags, as in the JAX package."""
    if name not in DATASETS:
        raise KeyError(f"unknown dataset '{name}'; available: {list(DATASETS)}")
    return lambda parser, is_train: parser


def create_dataset(opt):
    """The dataset named by opt.dataset_mode: "aligned" reads straightened
    CT folders (data/aligned.py), "synthetic" builds spines in memory."""
    get_option_setter(opt.dataset_mode)
    if opt.dataset_mode == "aligned":
        from .aligned import AlignedDataset as factory
    else:
        from .synthetic import SyntheticDataset as factory
    dataset = factory(opt)
    print(f"dataset [{type(dataset).__name__}] was created")
    return dataset
