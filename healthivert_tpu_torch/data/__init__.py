"""Host-side slice sampling and synthetic spine volumes (numpy, scipy), and
the dataset factory of the training driver."""


def create_dataset(opt):
    """The dataset named by opt.dataset_mode (healthivert_tpu/data/
    __init__.py:21-26). Only "synthetic" is ported; "aligned", which reads
    straightened CT folders, comes with the training CLI."""
    if opt.dataset_mode != "synthetic":
        raise NotImplementedError(
            f"dataset_mode={opt.dataset_mode!r} is not ported yet (queued in "
            "ROADMAP.md with the training CLI); use 'synthetic'"
        )
    from .synthetic import SyntheticDataset

    dataset = SyntheticDataset(opt)
    print(f"dataset [{type(dataset).__name__}] was created")
    return dataset
